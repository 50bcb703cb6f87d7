"""The paper's 9 evaluated algorithms = {FedAvg, FedProx, PerFed} × {SYN, S², ASY}.

Names follow the figures:  FedAvg-SYN, FedProx-SYN, PerFed-SYN, FedAvgS2,
FedProxS2, PerFedS2 (the paper's contribution), FedAvg-ASY, FedProx-ASY,
PerFed-ASY.
"""
from __future__ import annotations

from typing import Dict, Tuple

_MODES = {"SYN": "sync", "S2": "semi", "ASY": "async"}
_FAMILIES = {"FedAvg": "fedavg", "FedProx": "fedprox", "PerFed": "perfed"}

ALGORITHMS: Dict[str, Tuple[str, str]] = {}
for fam, algo in _FAMILIES.items():
    for suffix, mode in _MODES.items():
        name = f"{fam}S2" if suffix == "S2" else f"{fam}-{suffix}"
        ALGORITHMS[name] = (algo, mode)


def algorithm_name(algorithm: str, mode: str) -> str:
    fam = {v: k for k, v in _FAMILIES.items()}[algorithm]
    suffix = {v: k for k, v in _MODES.items()}[mode]
    return f"{fam}S2" if suffix == "S2" else f"{fam}-{suffix}"
