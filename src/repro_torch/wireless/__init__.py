from repro_torch.wireless.channel import EdgeNetwork, sample_channels
from repro_torch.wireless.timing import compute_time, round_time, upload_time

__all__ = [
    "EdgeNetwork",
    "compute_time",
    "round_time",
    "sample_channels",
    "upload_time",
]
