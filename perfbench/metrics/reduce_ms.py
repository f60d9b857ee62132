"""Device ms a scene in RAMS's temporal reduction (RFABs and the convs
valid along time, T 9 -> 3): the program's ``rams.reduce`` spans over the
traced scenes."""

from perfbench import spans


def read(ctx):
    return spans.per(spans.records(), ("rams.reduce",), "device_ms", ctx["traced_items"])
