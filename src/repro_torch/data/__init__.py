from repro_torch.data.partition import ClientDataset, partition_noniid
from repro_torch.data.synthetic import (
    synthetic_cifar,
    synthetic_lm_corpus,
    synthetic_mnist,
    synthetic_shakespeare,
)

__all__ = [
    "ClientDataset",
    "partition_noniid",
    "synthetic_cifar",
    "synthetic_lm_corpus",
    "synthetic_mnist",
    "synthetic_shakespeare",
]
