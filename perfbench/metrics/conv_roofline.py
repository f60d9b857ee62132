"""The traced calls' conv FLOPs over the device time of the conv and GEMM
kernels, as a percent of the float32 peak."""

from perfbench import flops, trace as tracing


def read(ctx):
    s = ctx["trace"]
    conv_s = s and s["by_category"].get(tracing.CONV)
    if not conv_s:
        return None
    return 100.0 * ctx["conv_flops_per_item"] * ctx["traced_items"] / conv_s / flops.H100_F32_FLOPS
