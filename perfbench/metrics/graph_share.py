"""Percent of the traced train steps that ran through CUDA graphs: the
program's ``train.step`` spans with a ``train.step.replay`` span inside
them, over all its ``train.step`` spans. None for a program without the
step's graphs (``highresnet_tpu_torch.train.graphs``) or without a
``train.step`` span."""

from perfbench import spans


def read(ctx):
    try:
        import highresnet_tpu_torch.train.graphs  # noqa: F401
    except ImportError:  # a program that replays no graphs
        return None
    recs = spans.records()
    steps = {r["id"] for r in recs if r["name"] == "train.step"}
    if not steps:
        return None
    parent = {r["id"]: r["parent"] for r in recs}
    replayed = set()
    for r in recs:
        if r["name"] == "train.step.replay":
            up = r["parent"]
            while up is not None and up not in steps:
                up = parent.get(up)
            if up is not None:
                replayed.add(up)
    return 100.0 * len(replayed) / len(steps)
