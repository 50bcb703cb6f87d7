"""ssd_roofline.eval: the SSD chunk kernel's least time (its j <= i
products once at the TF32 peak, against its bytes) over the device time
of its launches in the traced calls, in percent."""
KERNEL = ("ssd_chunk_kernel",)


def read(trace, work):
    bound = work.get("ssd_bound_s")
    seconds, launches = trace.seconds(KERNEL)
    if bound is None or launches == 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
