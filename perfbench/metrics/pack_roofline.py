"""K1's share of its roofline: the bytes each fusion round must move (each
paired state read once, each pair written once) over the device time of
``pack_pairs_kernel``, percent of 3.35 TB/s."""

from perfbench import flops


def read(ctx):
    s = ctx["trace"]
    if s is None:
        return None
    seconds = sum(v for k, v in s["by_name"].items()
                  if "pack_pairs_kernel" in k.lower() and "unpack" not in k.lower())
    if not seconds:
        return None
    moved = ctx["pack_bytes_per_item"] * ctx["traced_items"]
    return 100.0 * moved / seconds / flops.H100_HBM_BYTES_PER_S
