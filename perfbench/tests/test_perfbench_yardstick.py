"""The benchmark's copies of the yardstick: the FLOP counts against the
program's ``utils/flops.py`` at every cell's shapes, the trace summary on a
canned trace, the readers on a canned context, and K1's byte count."""

import json

import pytest

from highresnet_tpu_torch.utils import flops as program_flops
from perfbench import cells, flops, trace
from perfbench.drivers import archive
from perfbench.tests.conftest import cells as cell_names


@pytest.mark.parametrize("cell", cell_names())
def test_flop_counts_equal_the_programs(cell):
    c = cells.load_cell(cell)
    net, t, p = c.config["network"], c.config["training"], c.traffic
    if p["kind"] == "train":
        args = (net, t["batch_size"], t["min_L"], t["patch_size"], t.get("register_size", 128))
        assert flops.train_step_flops(*args) == program_flops.train_step_flops(*args)
    else:
        args = (net, p.get("batch", 1), p["views"], p["lr_size"])
        assert flops.hrnet_forward_flops(*args) == program_flops.hrnet_forward_flops(*args)
    assert flops.H100_F32_FLOPS == program_flops.H100_PEAK_TFLOPS["float32"] * 1e12


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(trace.MARK, "user_annotation", 0, 100),
    ev("aten::conv2d", "cpu_op", 0, 30),
    ev("cudaLaunchKernel", "cuda_runtime", 2, 6),  # innermost at [0, 10)'s middle
    ev("Model.forward host copy", "cpu_op", 60, 20),
    ev("cudnn::fft2d_r2c_32x32", "kernel", 10, 40),
    ev("void pack_pairs_kernel<4>", "kernel", 45, 10),  # overlaps the conv
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 90, 10),
]


def test_trace_summary_on_a_canned_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    s = trace.summarize(trace.load_events(path))
    assert s["busy_s"] == pytest.approx(55e-6)  # [10, 55) and [90, 100)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["by_category"][trace.CONV] == pytest.approx(40e-6)
    assert s["by_category"][trace.PORT] == pytest.approx(10e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == {"cudaLaunchKernel": pytest.approx(10e-6),  # [0, 10)
                    "Model.forward host copy": pytest.approx(35e-6)}  # [55, 90)
    assert s["breakdown"]["device_ops"][0] == ["cudnn::fft2d_r2c_32x32", pytest.approx(40e-6)]
    assert trace.summarize([ev("aten::add", "cpu_op", 0, 5)]) is None


def test_readers_on_a_canned_context():
    s = trace.summarize(EVENTS)
    ctx = {"trace": s, "items": 10, "window_s": 2.0, "traced_items": 1, "latencies_s": [1, 2, 3],
           "flops_per_item": flops.H100_F32_FLOPS * 0.1, "conv_flops_per_item": 67e12 * 40e-6 / 2,
           "pack_bytes_per_item": 3.35e12 * 10e-6 / 4}
    def read(metric, c=ctx):
        return cells.reader(metric).read(c)

    assert read("idle_share.train") == pytest.approx(45.0)
    assert read("mfu.archive") == pytest.approx(50.0)
    assert read("conv_roofline.tta8") == pytest.approx(50.0)
    assert read("tta8_p50_ms") == 2000
    assert read("pack_roofline.archive") == pytest.approx(25.0)
    assert read("conv_roofline.train", {**ctx, "trace": None}) is None
    assert read("pack_roofline.archive", {**ctx, "trace": None}) is None


def test_k1_bytes():
    # 16 views: rounds of 8, 4, 2, 1 pairs; each pair's two states read and its pair written
    per_state = 64 * 128 * 128 * 4
    assert archive.pack_bytes(8, 16, 64, 128) == 2 * 8 * (16 + 8 + 4 + 2) * per_state
    assert archive.pack_bytes(1, 5, 8, 4) == 2 * (4 + 2) * 8 * 4 * 4 * 4
