from repro_torch.mobility.models import (
    Area,
    GaussMarkov,
    MobilityModel,
    RandomWaypoint,
    StaticMobility,
    get_mobility,
)
from repro_torch.mobility.multicell import MultiCellNetwork, cell_layout

__all__ = [
    "Area",
    "GaussMarkov",
    "MobilityModel",
    "MultiCellNetwork",
    "RandomWaypoint",
    "StaticMobility",
    "cell_layout",
    "get_mobility",
]
