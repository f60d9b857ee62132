"""Device ms a scene in RAMS's features (the normalisation, the view fill
and the 3-D body of residual feature-attention blocks): the program's
``rams.features`` spans over the traced scenes."""

from perfbench import spans


def read(ctx):
    return spans.per(spans.records(), ("rams.features",), "device_ms", ctx["traced_items"])
