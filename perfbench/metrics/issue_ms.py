"""Host ms to issue one train step: the program's ``train.step`` spans'
host time over their count."""

from perfbench import spans


def read(ctx):
    recs = spans.records()
    return spans.per(recs, ("train.step",), "host_ms", spans.steps(recs))
