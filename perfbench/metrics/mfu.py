"""Model FLOPs of the window's work (``flops.py``'s direct-conv count)
over the window's seconds, as a percent of the float32 peak."""

from perfbench import flops


def read(ctx):
    if not ctx["window_s"]:
        return None
    return 100.0 * ctx["flops_per_item"] * ctx["items"] / ctx["window_s"] / flops.H100_F32_FLOPS
