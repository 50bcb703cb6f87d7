from repro_torch.data.partition import ClientDataset, partition_noniid
from repro_torch.data.synthetic import synthetic_mnist

__all__ = ["ClientDataset", "partition_noniid", "synthetic_mnist"]
