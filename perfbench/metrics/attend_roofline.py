"""The attention core's share of its roofline: the bytes it must move (q,
k and v read once, its output written once, in every block;
``flops_trmisr.attend_bytes``) over the device time of the program's
``trmisr.attend`` spans, percent of 3.35 TB/s. It reads the same work
whatever computes the core."""

from perfbench import flops, spans


def read(ctx):
    ms = spans.per(spans.records(), ("trmisr.attend",), "device_ms", ctx["traced_items"])
    if not ms:
        return None
    return 100.0 * ctx["attend_bytes_per_item"] / (ms * 1e-3) / flops.H100_HBM_BYTES_PER_S
