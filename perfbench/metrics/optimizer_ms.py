"""Device ms a train step in the gradients' fill and Adam's update: the
program's ``train.step.zero_grad`` and ``train.step.optimizer`` spans over
its ``train.step`` spans."""

from perfbench import spans

NAMES = ("train.step.zero_grad", "train.step.optimizer")


def read(ctx):
    recs = spans.records()
    return spans.per(recs, NAMES, "device_ms", spans.steps(recs))
