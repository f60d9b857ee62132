"""The perf labs' port (``highresnet_tpu_torch/labs/``) against the JAX
package and the JAX labs, on the CPU at a tiny size (batch 2, 4-5 views,
16 px, 8 channels):

- fusion_lab's ``v0_current`` against the JAX HRNet's ``fuse`` and
  ``d0_current`` against its ``decode``, on weights carried over by
  ``models/convert.py::hrnet_state_dict_from_flax`` (f32, 1e-5 of the
  output's largest magnitude); every variant (v1, v2, fusion_lab2's
  v3_flat; d1) against its control at the same tolerance;
- fusion_lab3's pack routes against the JAX package's ``pack_pairs_pallas``
  (Pallas interpret mode) and ``pack_pairs_xla``, NHWC against NCHW, bit for
  bit;
- bench_breakdown's stages chained equal ``HRNet.forward`` exactly;
- the trace summarizer on a canned Chrome trace (categories sum to the
  device total, the top ops in order, the idle share, kernel names to
  categories) and ``--resummarize`` without a card;
- each lab's ``main(["--device", "cpu", ...])`` writes its JAX counterpart's
  report keys to ``--out`` and nothing else, and a CUDA request without a
  card raises.
"""

import gzip
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.models.hrnet import HRNet as JaxHRNet
from highresnet_tpu.ops.fusion_pallas import pack_pairs_pallas, pack_pairs_xla
from highresnet_tpu_torch.labs import (
    bench_breakdown,
    common,
    fusion_lab,
    fusion_lab2,
    fusion_lab3,
    trace_train_step,
)
from highresnet_tpu_torch.models import HRNet, hrnet_state_dict_from_flax

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "highresnet_tpu_torch" / "csrc"
THREADS = 2  # the suite runs files in parallel workers (ROADMAP H12)
B, S, C = 2, 16, 8
RTOL = 1e-5  # f32 on the CPU: the same sums in another order, relative to max|out|
NET = common.network(C)
SHAPE = ["--batch", "2", "--views", "4", "--size", "16", "--channels", "8",
         "--iters", "2", "--warmup", "1"]
TRACE_SHAPE = ["--batch", "2", "--views", "4", "--patch", "16", "--channels", "8",
               "--register-size", "32", "--steps", "1"]
# the JAX labs' report keys: examples/fusion_lab.py:101-102, 152-172, 194-197;
# fusion_lab2.py:85, 121-135, 155-169, 190; fusion_lab3.py:79-85, 114-131;
# bench_breakdown.py:69, 108-121; trace_train_step.py:131-147
JAX_KEYS = {
    "fusion_lab": {"device", "dtype", "batch", "views", "size", "fusion", "decoder"},
    "fusion_lab2": {"device", "dtype", "p_concat_s", "p_gate_s", "p_mean_s", "bw_c64", "bw_c128",
                    "bw_concat64", "full_v0_s", "conv_only_s", "v3_flat_s"},
    "fusion_lab3": {"device", "dtype", "pack_pallas", "pack_xla", "fusion_gated_s",
                    "fusion_nogate_s", "gate_only_s"},
    "bench_breakdown": {"device", "batch", "views", "size", "stages"},
    "trace_train_step": {"device", "program", "note", "device_ms_per_step",
                         "category_accounting_ms_per_step", "ceiling_accounting", "top_ops"},
}
LABS = {"fusion_lab": fusion_lab, "fusion_lab2": fusion_lab2, "fusion_lab3": fusion_lab3,
        "bench_breakdown": bench_breakdown, "trace_train_step": trace_train_step}
ROOT_RECORDS = ("FUSION_LAB.json", "FUSION_LAB2.json", "FUSION_LAB3.json", "BENCH_BREAKDOWN.json",
                "TRACE_BF16_SUMMARY.json", "TRACE_BF16_TRAIN_SUMMARY.json",
                "TRACE_F32_TRAIN_SUMMARY.json")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX HRNet at the tiny width, its seed-0 params, and one jitted
    ``fuse`` and ``decode`` (H12: one compile per function and shape)."""
    model = JaxHRNet(config=NET)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, S, S), jnp.float32),
                                 jnp.ones((1, 2), jnp.float32))["params"]
    fuse = jax.jit(lambda x, a: model.apply({"params": params}, x, a,
                                            method=lambda m, x, a: m.fuse(x, a)))
    decode = jax.jit(lambda x: model.apply({"params": params}, x,
                                           method=lambda m, x: m.decode(x)))
    return jax.tree_util.tree_map(np.asarray, params), fuse, decode


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = HRNet(NET).eval()
    model.load_state_dict(hrnet_state_dict_from_flax(jax_model[0]))
    return model


def _states(l: int, seed: int = 0):
    """NHWC states (B, L, S, S, C) and alphas with scene 1's last view padded."""
    x = np.random.default_rng(seed).standard_normal((B, l, S, S, C)).astype(np.float32)
    alphas = np.ones((B, l), np.float32)
    alphas[1, -1] = 0.0
    return x, alphas


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 1, 4, 2, 3).contiguous()


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= RTOL * scale


# --------------------------------------------------------------------------
# fusion_lab and fusion_lab2 against the JAX package and each other


@pytest.mark.parametrize("l", [4, 5])
def test_v0_current_equals_jax_fuse(jax_model, port_model, l):
    x, alphas = _states(l)
    want = np.array(jax_model[1](jnp.asarray(x), jnp.asarray(alphas)))  # (B, S, S, C)
    with torch.inference_mode():
        got = fusion_lab.v0_current(port_model.fuse, _nchw(x), torch.from_numpy(alphas))
    _close(got.permute(0, 2, 3, 1), torch.from_numpy(want))


@pytest.mark.parametrize("variant", ["v1_no_concat", "v2_dist_residual", "v3_flat"])
@pytest.mark.parametrize("l", [4, 5])
def test_fusion_variants_equal_v0(port_model, variant, l):
    x, alphas = _states(l, seed=1)
    xt, at = _nchw(x), torch.from_numpy(alphas)
    with torch.inference_mode():
        want = fusion_lab.v0_current(port_model.fuse, xt, at)
        if variant == "v3_flat":
            got = fusion_lab2.v3_flat(port_model.fuse, *fusion_lab2.to_flat(xt, at), B)
        else:
            got = getattr(fusion_lab, variant)(port_model.fuse, xt, at)
    assert got.shape == want.shape == (B, C, S, S)
    _close(got, want)


def test_d0_current_equals_jax_decode_and_the_decoder(jax_model, port_model):
    z = np.random.default_rng(2).standard_normal((B, S, S, C)).astype(np.float32)
    want = np.array(jax_model[2](jnp.asarray(z)))  # (B, 3S, 3S, 1)
    zt = torch.from_numpy(z).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        got = fusion_lab.d0_current(port_model.decode, zt)
        assert torch.equal(got, port_model.decode(zt))
    assert got.shape == (B, 1, 3 * S, 3 * S)
    _close(got.permute(0, 2, 3, 1), torch.from_numpy(want))


def test_d1_pre_d2s_equals_d0(port_model):
    zt = torch.from_numpy(np.random.default_rng(3).standard_normal((B, C, S, S)).astype(np.float32))
    with torch.inference_mode():
        want = fusion_lab.d0_current(port_model.decode, zt)
        got = fusion_lab.d1_pre_d2s(port_model.decode, zt)
    assert got.shape == want.shape
    _close(got, want)


# --------------------------------------------------------------------------
# fusion_lab3's pack routes, bench_breakdown's stages


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [4, 5])
def test_lab3_pack_routes_equal_jax_packs(l, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = np.random.default_rng(l).standard_normal((B, l, 4, 5, 3)).astype(np.float32)  # NHWC
    xj = jnp.asarray(x, jdt)
    wants = [np.asarray(f(xj).astype(jnp.float32))
             for f in (lambda v: pack_pairs_pallas(v, interpret=True), pack_pairs_xla)]
    xt = _nchw(x).to(common.DTYPES[dtype])
    for name, pack in fusion_lab3.ROUTES.items():
        got = pack(xt)
        assert got.dtype == xt.dtype, name
        got = got.float().permute(0, 1, 3, 4, 2).numpy()  # back to NHWC
        assert got.shape == (B, l // 2, 4, 5, 6)
        for want in wants:
            assert np.array_equal(got, want), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_breakdown_stages_chain_to_the_forward(dtype):
    model = common.seeded_hrnet(C, torch.device("cpu"), common.DTYPES[dtype])
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((B, 10, S, S)).astype(np.float32))
    alphas = torch.ones((B, 10))
    alphas[0, 7:] = 0.0
    with torch.inference_mode():
        x = bench_breakdown.prep(model, lrs)
        states = bench_breakdown.encode(model, x, B)
        fused = bench_breakdown.fuse(model, states, alphas)
        got = bench_breakdown.decode(model, fused)
        want = model(lrs, alphas)
    assert x.dtype == common.DTYPES[dtype] and states.shape == (B, 10, C, S, S)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# --------------------------------------------------------------------------
# the trace summarizer


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 7}


KERNELS = [  # (name, category) as the H100's Chrome traces name them
    ("void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*, float2 const*, int, "
     "cudnn::reduced_divisor, bool, float*, float*, int2, cudnnActivationStruct)",
     trace_train_step.CONV),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int, int)",
     trace_train_step.CONV),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_"
     "alignc4_execute_kernel__5x_cublas", trace_train_step.CONV),
    ("(anonymous namespace)::pack_pairs_kernel(unsigned char const*, unsigned char*, long, long, "
     "long, long)", trace_train_step.PORT),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, "
     "false, true, (cudnnKernelDataType_t)0>(cudnn::engines_precompiled::nchw2nhwc_params_t"
     "<float>)",
     "copies and memsets"),
    ("Memset (Device)", "copies and memsets"),
    ("void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, true, 1>(float, float, float, "
     "float, cudnnTensorStruct, float const*)", "reductions"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::prelu_kernel>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<FusedAdam>",
     "optimizer (multi_tensor_apply)"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nchw<float, float, int>(float "
     "const*, long const*, int, int)", "other"),
]


def _canned_trace(path: Path) -> list:
    """Two steps: each step span starts 10 us before its first kernel; two
    kernels of the first step overlap by 5 us; runtime calls and the GPU-side
    span are not device time."""
    events, ts = [], 0.0
    for step in range(2):
        events.append({"ph": "X", "cat": "user_annotation", "name": trace_train_step.STEP_MARK,
                       "ts": ts, "dur": 500.0})
        t = ts + 10.0
        for i, (name, _) in enumerate(KERNELS):
            cat = "gpu_memset" if name.startswith("Memset") else "kernel"
            dur = 10.0 * (i + 1)
            events.append(_kernel(name, t, dur, cat))
            t += dur - (5.0 if (step, i) == (0, 0) else 0.0)
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                       "dur": 3.0})
        events.append({"ph": "X", "cat": "gpu_user_annotation",
                       "name": trace_train_step.STEP_MARK, "ts": ts + 10.0, "dur": 550.0})
        ts = t + 20.0
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": [{"ph": "M", "name": "process_name", "pid": 1,
                                    "args": {"name": "GPU 0"}}, *events]}, f)
    return events


def test_kernel_names_map_to_their_categories():
    for name, category in KERNELS:
        assert trace_train_step.categorize(name) == category, name
    # every kernel of the port's CUDA sources, as the trace names it
    globals_ = [re.search(r"\)\s*(\w+)\(", m).group(1) for src in sorted(CSRC.glob("*.cu"))
                for m in re.findall(r"__global__ void[^(]*\([^)]*\)\s*\w+\(", src.read_text())]
    assert len(globals_) == 4, globals_
    for name in globals_:
        traced = f"(anonymous namespace)::{name}(unsigned char const*, float*, long)"
        assert trace_train_step.categorize(traced) == trace_train_step.PORT, name


def test_summarizer_accounts_for_the_canned_trace(tmp_path):
    events = _canned_trace(tmp_path / "trace.json.gz")
    s = trace_train_step.summarize_chrome_trace(tmp_path / "trace.json.gz", steps=2)
    per_step_us = sum(10.0 * (i + 1) for i in range(len(KERNELS)))
    assert s["device_ms_per_step"] == pytest.approx(per_step_us / 1e3)
    cats = s["category_accounting_ms_per_step"]
    assert sum(cats.values()) == pytest.approx(s["device_ms_per_step"])
    assert list(cats.values()) == sorted(cats.values(), reverse=True)
    assert cats[trace_train_step.CONV] == pytest.approx(0.060)  # 10 + 20 + 30 us
    assert cats["other"] == pytest.approx(0.100) and s["other_share"] == pytest.approx(100 / 550)
    top = s["top_ops"]
    assert [r["us_per_step"] for r in top] == sorted((r["us_per_step"] for r in top), reverse=True)
    assert top[0]["op"] == KERNELS[-1][0] and top[0]["count_per_step"] == 1.0
    assert sum(r["pct"] for r in top) == pytest.approx(100.0)
    # the busy union is 2 x 550 us less the 5 us overlap; the window runs from
    # the first step span to the last kernel's end
    kernels = [e for e in events if e["cat"] in ("kernel", "gpu_memset")]
    window = max(e["ts"] + e["dur"] for e in kernels) - 0.0
    assert s["idle_share"] == pytest.approx(1 - (1100.0 - 5.0) / window)


def test_resummarize_needs_no_card(tmp_path, monkeypatch):
    trace_dir = tmp_path / "traces" / "bf16_train"
    _canned_trace(trace_dir / "trace.json.gz")
    out = tmp_path / "summary.json"
    out.write_text(json.dumps({"device": "NVIDIA H100 80GB HBM3, 700.00 W", "steps": 2,
                               "batch": 32, "views": 32, "patch": 64, "dtype": "bfloat16"}))
    breakdown = tmp_path / "bb.json"
    breakdown.write_text(json.dumps({"stages": {"bfloat16": {
        "conv64_stack": {"tflops_per_s": 100.0}, "conv128_stack": {"tflops_per_s": 150.0}}}}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_device(_):
        raise AssertionError("--resummarize must not set up a device")

    monkeypatch.setattr(trace_train_step, "setup_device", no_device)
    summary = trace_train_step.main(["--resummarize", "--trace-dir", str(trace_dir), "--out",
                                     str(out), "--breakdown", str(breakdown)])
    assert json.loads(out.read_text()) == summary
    assert summary["device"].startswith("NVIDIA H100") and summary["resummarized"] is True
    ceiling = summary["ceiling_accounting"]
    flops = trace_train_step.train_step_flops(common.network(64), 32, 32, 64, 128)
    assert ceiling["train_step_tflop"] == pytest.approx(flops / 1e12)
    assert ceiling["conv_tflops_per_s"] == pytest.approx(flops / 60e-6 / 1e12)
    assert ceiling["stack_ceiling_tflops_per_s"] == 150.0
    assert ceiling["peak_tflops_per_s"] == 989.0
    assert ceiling["non_conv_ms_per_step"] == pytest.approx(0.550 - 0.060)


# --------------------------------------------------------------------------
# the entry points


def _files(root: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()} if root.exists() \
        else {}


@pytest.mark.parametrize("lab", sorted(LABS))
def test_lab_main_on_the_cpu_writes_only_its_out_with_the_jax_keys(lab, tmp_path, monkeypatch):
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    records = {name: (REPO / name).read_bytes() for name in ROOT_RECORDS}
    build = {d: _files(REPO / "build" / d) for d in ("labs", "traces")}
    out = tmp_path / "report" / f"{lab}.json"
    argv = ["--device", "cpu", "--out", str(out)]
    if lab == "trace_train_step":
        argv += [*TRACE_SHAPE, "--dtype", "float32", "--trace-dir", str(tmp_path / "trace"),
                 "--breakdown", str(tmp_path / "none.json")]
    else:
        argv += SHAPE + (["--dtype", "float32"] if lab.startswith("fusion") else [])
    report = LABS[lab].main(argv)

    assert JAX_KEYS[lab] <= set(report) and report["device"] == "cpu"
    assert json.loads(out.read_text()) == report
    assert [p.name for p in out.parent.iterdir()] == [f"{lab}.json"] and not any(work.iterdir())
    assert all((REPO / name).read_bytes() == data for name, data in records.items())
    assert {d: _files(REPO / "build" / d) for d in build} == build
    assert report["launches"] == {"pack": 0, "unpack": 0}  # the CPU takes the plain versions
    if lab == "fusion_lab":
        assert {"v0_current_s", "v_conv_only_s", "v1_no_concat_s", "v2_dist_residual_s",
                "v1_max_abs_diff", "v2_max_abs_diff"} <= set(report["fusion"])
        assert {"d0_current_s", "d1_pre_d2s_s", "d1_max_abs_diff"} <= set(report["decoder"])
        for v in ("v1", "v2"):
            assert report["fusion"][f"{v}_max_abs_diff"] <= RTOL * report["fusion"]["v0_max_abs"]
        assert report["decoder"]["d1_max_abs_diff"] <= RTOL * report["decoder"]["d0_max_abs"]
    elif lab == "fusion_lab2":
        for probe in ("bw_c64", "bw_c128", "bw_concat64"):
            assert report[probe]["gb_per_s"] > 0 and report[probe]["share_of_hbm"] is None
        assert report["v3_max_abs_diff"] <= RTOL * report["v0_max_abs"]
    elif lab == "fusion_lab3":
        assert report["pack_equal"] is True
        assert {"step_s", "gb_per_s"} <= set(report["pack_pallas"]) == set(report["pack_xla"])
    elif lab == "bench_breakdown":
        assert set(report["stages"]) == {"float32", "bfloat16"}
        for row in report["stages"].values():
            assert {"full_forward_s", "prep_median_stack_s", "encoder_s", "fusion_s",
                    "decoder_s", "stage_sum_s"} <= set(row)
            for stack in ("conv64_stack", "conv128_stack"):
                assert row[stack]["flops"] == 2.0 * 8 * 16 * 16 * 9 * 8 * 8 * 6
                assert row[stack]["tflops_per_s"] > 0
        assert report["cudnn"]["cudnn_benchmark"] is False
    else:  # on the CPU the profiler sees no device
        assert report["device_ms_per_step"] is None and report["top_ops"] == []
        assert report["loss_finite"] is True and report["steps_run"] == 2 + 1 + 2
        assert (tmp_path / "trace" / "trace.json.gz").is_file()


@pytest.mark.parametrize("lab", sorted(LABS))
def test_lab_cuda_request_without_a_card_raises(lab, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--device", "cuda", "--out", str(tmp_path / "x.json")]
    if lab == "trace_train_step":
        argv += ["--trace-dir", str(tmp_path / "trace")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LABS[lab].main(argv)
    assert not any(tmp_path.iterdir())


def test_default_outs_are_under_build():
    assert fusion_lab.parse_args([]).out == str(REPO / "build" / "labs" / "fusion_lab_torch.json")
    assert bench_breakdown.parse_args([]).out == str(
        REPO / "build" / "labs" / "bench_breakdown_torch.json")
    args = trace_train_step.parse_args(["--dtype", "float32"])
    assert args.out == str(REPO / "build" / "labs" / "trace_train_step_f32_torch.json")
    assert args.trace_dir == str(REPO / "build" / "traces" / "f32_train")
    row = trace_train_step.train_row(args)
    assert (row.name, row.batch, row.views, row.size) == ("train step f32", 32, 32, 64)
