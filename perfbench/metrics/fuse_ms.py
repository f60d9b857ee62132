"""Device ms a scene in HRNet's fusion stage: the program's ``hrnet.fuse``
spans over the traced scenes (all eight forwards of a TTA scene). The
in-program counterpart of ``fusion_share``'s hooks."""

from perfbench import spans


def read(ctx):
    return spans.per(spans.records(), ("hrnet.fuse",), "device_ms", ctx["traced_items"])
