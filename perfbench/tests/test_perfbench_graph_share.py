"""``graph_share``'s reader on canned span records: the share of the
``train.step`` spans that hold a ``train.step.replay``, however deep; None
without a ``train.step`` span or for a program without the step's graphs."""

import sys

import pytest

from perfbench import cells, spans


def rec(name, id, parent):
    return {"name": name, "id": id, "parent": parent, "root": 1, "host_ms": 1.0,
            "device_ms": 1.0}


EAGER = [rec("train.step", 2, 1), rec("train.step.zero_grad", 3, 2),
         rec("train.step.forward", 4, 2), rec("train.step.optimizer", 5, 2)]
CAPTURED = [rec("train.step", 6, 1), rec("train.step.capture", 7, 6),
            rec("train.step.capture", 8, 6), rec("train.step.zero_grad", 9, 6),
            rec("train.step.replay", 10, 9), rec("train.step.replay", 11, 6)]
REPLAYED = [rec("train.step", 12, 1), rec("train.step.zero_grad", 13, 12),
            rec("train.step.replay", 14, 13), rec("train.step.replay", 15, 12),
            rec("train.step.optimizer", 16, 12), rec("train.step.replay", 17, 16)]
EPOCH = [rec("train.epoch", 1, None), rec("train.feed", 18, 1)]


@pytest.mark.parametrize("metric", ["graph_share.train", "graph_share.ref_train"])
@pytest.mark.parametrize("records, want", [
    (EPOCH + EAGER + CAPTURED + REPLAYED, 100.0 * 2 / 3),
    (EPOCH + REPLAYED, 100.0),
    (EPOCH + EAGER, 0.0),
    (EPOCH, None),
    ([], None),
])
def test_graph_share_on_canned_records(metric, records, want, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: records)
    got = cells.reader(metric).read({"traced_items": 3})
    assert got is None if want is None else got == pytest.approx(want)


def test_graph_share_of_a_program_without_graphs(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: EPOCH + EAGER)
    monkeypatch.setitem(sys.modules, "highresnet_tpu_torch.train.graphs", None)
    assert cells.reader("graph_share.train").read({"traced_items": 1}) is None
