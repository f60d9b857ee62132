"""Device ms a scene in RAMS's attention gates (each a mean, two 1x1
convs, a sigmoid, the scale and the residual add): the program's
``rams.gate`` spans, nested in the stages, over the traced scenes."""

from perfbench import spans


def read(ctx):
    return spans.per(spans.records(), ("rams.gate",), "device_ms", ctx["traced_items"])
