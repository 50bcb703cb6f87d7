# The paper's primary contribution: PerFedS² — semi-synchronous
# personalized federated averaging with joint bandwidth allocation + UE
# scheduling.
from repro_torch.core.bandwidth import lambertw, optimal_bandwidth
from repro_torch.core.convergence import fosp_bound, step_condition
from repro_torch.core.perfed import (
    adapt,
    perfed_grad,
    perfed_grad_exact,
    perfed_loss,
)
from repro_torch.core.scheduler import (
    estimate_A_K,
    greedy_schedule,
    relative_frequencies,
)

__all__ = [
    "adapt",
    "estimate_A_K",
    "fosp_bound",
    "greedy_schedule",
    "lambertw",
    "optimal_bandwidth",
    "perfed_grad",
    "perfed_grad_exact",
    "perfed_loss",
    "relative_frequencies",
    "step_condition",
]
