"""The share of the traced window in which no operation ran on the card
(1 - the union of kernels, copies and sets over the window), in
percent."""


def read(trace, work):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
