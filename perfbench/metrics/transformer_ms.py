"""Device ms a scene in TR-MISR's transformer fusion (the tokens, every
block, the final norm and the token's row): the program's
``trmisr.transformer`` spans over the traced scenes."""

from perfbench import spans


def read(ctx):
    return spans.per(spans.records(), ("trmisr.transformer",), "device_ms", ctx["traced_items"])
