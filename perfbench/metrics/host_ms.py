"""Host ms a scene in the parts of a serving call during which the card
holds none of the scene's work: the program's ``serve.collate``,
``serve.to_device`` and ``serve.range_check`` spans over the traced scenes."""

from perfbench import spans

NAMES = ("serve.collate", "serve.to_device", "serve.range_check")


def read(ctx):
    return spans.per(spans.records(), NAMES, "host_ms", ctx["traced_items"])
