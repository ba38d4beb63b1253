"""The frames' least work (``workcount``: content bytes and output bytes
once, the operations the content needs) at the card's peaks, over the
kernels' device time, %."""

from swfbench.workcount import bound_seconds


def read(traced):
    kernel_s = traced.timeline.device_seconds("kernel")
    if traced.peak is None or kernel_s <= 0:
        return None
    return 100.0 * bound_seconds(*traced.work, traced.peak) / kernel_s
