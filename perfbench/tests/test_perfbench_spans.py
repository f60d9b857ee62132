"""The readers of the program's spans on canned records, and the trace
summary naming an idle gap by the program span open over it."""

import pytest

from perfbench import cells, spans, trace


def rec(name, host_ms, device_ms=None):
    return {"name": name, "id": 0, "parent": None, "root": 0, "host_ms": host_ms,
            "device_ms": device_ms}


RECORDS = [
    rec("serve.scene", 300.0, 290.0),
    rec("serve.collate", 1.0, 0.0),
    rec("serve.call", 280.0, 270.0),
    rec("serve.to_device", 0.5, 0.25),
    rec("hrnet.fuse", 40.0, 10.0),
    rec("hrnet.fuse.round", 9.0, 2.5),
    rec("hrnet.fuse", 30.0, 12.0),
    rec("serve.align", 6.0, 3.0),
    rec("serve.align", 7.0, 5.0),
    rec("serve.range_check", 0.25, 0.0),
    rec("train.epoch", 60.0, 70.0),
    rec("train.feed", 2.0, 1.5),
    rec("train.step", 20.0, 25.0),
    rec("train.step.zero_grad", 0.5, 1.0),
    rec("train.step.optimizer", 2.0, 3.0),
    rec("train.feed", 4.0, 2.0),
    rec("train.step", 30.0, 27.0),
    rec("train.step.zero_grad", 0.5, 1.0),
    rec("train.step.optimizer", 2.0, 5.0),
    rec("train.readback", 9.0, 8.0),
]
CTX = {"traced_items": 2}
WANT = {  # hand-computed from RECORDS over 2 scenes or 2 steps
    "fuse_ms.archive": (10.0 + 12.0) / 2,
    "fuse_ms.tta8": (10.0 + 12.0) / 2,
    "align_ms.tta8": (3.0 + 5.0) / 2,
    "host_ms.tta8": (1.0 + 0.5 + 0.25) / 2,
    "feed_ms.train": (2.0 + 4.0) / 2,
    "feed_ms.ref_train": (2.0 + 4.0) / 2,
    "issue_ms.ref_train": (20.0 + 30.0) / 2,
    "optimizer_ms.ref_train": (1.0 + 3.0 + 1.0 + 5.0) / 2,
}
DEVICE = {"fuse_ms.archive", "fuse_ms.tta8", "align_ms.tta8", "optimizer_ms.ref_train"}


def test_every_span_metric_is_listed():
    names = {m["name"] for m in cells._json(cells.ROOT.parent / "BENCHMARK.json")["per_layer"]
             if m["source"] == "program_span" and m["name"] != "fusion_share.archive"}
    assert names == set(WANT)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_canned_records(metric, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: RECORDS)
    assert cells.reader(metric).read(CTX) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_its_spans(metric, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: [])
    assert cells.reader(metric).read(CTX) is None
    # on the CPU the spans carry no device time
    host_only = [{**r, "device_ms": None} for r in RECORDS]
    monkeypatch.setattr(spans, "records", lambda: host_only)
    got = cells.reader(metric).read(CTX)
    assert got is None if metric in DEVICE else got == pytest.approx(WANT[metric])


def test_a_program_without_spans_gives_no_records(monkeypatch):
    from highresnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.records() == []
    assert cells.reader("issue_ms.ref_train").read(CTX) is None


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_a_gap_inside_a_program_span_takes_its_name():
    events = [
        ev(trace.MARK, "user_annotation", 0, 200),
        ev("train.epoch", "user_annotation", 0, 140),
        ev("train.step", "user_annotation", 5, 100),
        ev("cudaLaunchKernel", "cuda_runtime", 6, 2),
        ev("kernel a", "kernel", 10, 40),
        ev("kernel b", "kernel", 90, 10),  # [50, 90) idle inside train.step
        ev("kernel c", "kernel", 120, 10),  # [100, 120) inside train.epoch alone
        ev("kernel d", "kernel", 170, 10),  # [130, 170) outside every span
    ]
    gaps = dict(trace.summarize(events)["breakdown"]["idle_gaps"])
    assert gaps == {"train.step": pytest.approx(40e-6 + 10e-6),  # [50, 90) and [0, 10)
                    "train.epoch": pytest.approx(20e-6),
                    "(no host event)": pytest.approx(40e-6)}
