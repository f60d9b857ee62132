"""Percent of HRNet's device time a forward spends in its fusion stage,
from CUDA events that forward hooks record around ``hrnet`` and
``hrnet.fuse`` inside the real ``Model.forward`` call."""


def read(ctx):
    stages = ctx.get("stages_ms")
    if not stages or not stages["forward"]:
        return None
    return 100.0 * stages["fuse"] / stages["forward"]
