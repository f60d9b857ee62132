"""Host ms a train step in the epoch's feed: the program's ``train.feed``
spans (a batch's host-to-device copies, with any wait of a pageable copy
for the queue) over its ``train.step`` spans."""

from perfbench import spans


def read(ctx):
    recs = spans.records()
    return spans.per(recs, ("train.feed",), "host_ms", spans.steps(recs))
