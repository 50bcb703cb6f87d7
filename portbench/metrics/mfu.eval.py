"""mfu.eval: the forward FLOPs of the untraced calls of a traced run over
their host-clock time at the H100's bf16 peak, in percent.  The traced
calls that follow them would read low: the profiler slows the host."""
from portbench.work import H100_BF16_FLOPS


def read(trace, work):
    plain = work.get("untraced", {})
    if not plain.get("model_flops") or plain.get("seconds", 0) <= 0:
        return None
    return 100.0 * plain["model_flops"] / (plain["seconds"] * H100_BF16_FLOPS)
