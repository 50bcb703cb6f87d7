"""flash_roofline.eval: the flash kernel's least time (kept (b, h, q, k)
pairs x 4 x D at the bf16 peak, against q, k, v read and o written) over
the device time of its launches in the traced calls, in percent."""
KERNEL = ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_3xtf32_kernel")


def read(trace, work):
    bound = work.get("flash_bound_s")
    seconds, launches = trace.seconds(KERNEL)
    if bound is None or launches == 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
