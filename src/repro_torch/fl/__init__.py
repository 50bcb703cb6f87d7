from repro_torch.fl.algorithms import ALGORITHMS, algorithm_name
from repro_torch.fl.client import (global_eval, make_payload_fn,
                                   personalized_eval)
from repro_torch.fl.driver import TopologyAdapter, run_event_loop
from repro_torch.fl.engine import SimulationEngine, bucket_size
from repro_torch.fl.simulation import SimResult, run_simulation

__all__ = [
    "ALGORITHMS",
    "SimResult",
    "SimulationEngine",
    "TopologyAdapter",
    "algorithm_name",
    "bucket_size",
    "global_eval",
    "make_payload_fn",
    "personalized_eval",
    "run_event_loop",
    "run_simulation",
]
