"""Device ms a scene in the serving path's PCC alignment and mean: the
program's ``serve.align`` spans over the traced scenes."""

from perfbench import spans


def read(ctx):
    return spans.per(spans.records(), ("serve.align",), "device_ms", ctx["traced_items"])
