"""Model forwards a scene on the serving path: the program's
``serve.stack`` (several members of one model as one stacked forward) and
``serve.transform`` (one member's forward) spans over the traced scenes.
An x8 TTA scene reads 8 where each member runs alone and 1 where the eight
run as one stacked forward; a program without these spans gives None."""

from perfbench import spans

NAMES = ("serve.stack", "serve.transform")


def read(ctx):
    count = sum(r["name"] in NAMES for r in spans.records())
    return count / ctx["traced_items"] if count and ctx["traced_items"] else None
