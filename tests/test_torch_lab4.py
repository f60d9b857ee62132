"""The fusion lab's port against ``examples/fusion_lab4.py``: the plain packs
against the lab's own ``pack_dma`` (the TPU kernel K4, in Pallas interpret
mode), pair vs split conv against the lab's ``conv``, the lab's entry point
on the CPU, and the K4 wrapper's refusals. K4 itself runs only on a card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""

import functools
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from highresnet_tpu_torch.kernels import build
from highresnet_tpu_torch.labs import fusion_lab4
from highresnet_tpu_torch.ops import fusion, fusion_dma

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CONV_RTOL = 1e-5  # f32 on the CPU: the same sums in another order, relative to max|out|


@pytest.fixture(scope="module")
def jax_lab():
    """examples/fusion_lab4.py as it is; its import sets the compile cache
    directory, which is put back afterwards."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("fusion_lab4_jax",
                                                  REPO / "examples" / "fusion_lab4.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


def _to_nchw(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype).permute(0, 1, 4, 2, 3).contiguous()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("l", [2, 5, 16])
def test_plain_packs_match_the_labs_pack_dma(jax_lab, monkeypatch, l, dtype):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(l).standard_normal((2, l, 4, 5, 8)).astype(np.float32)  # NHWC
    want = np.asarray(jax_lab.pack_dma(jnp.asarray(x, jdt)).astype(jnp.float32))
    assert want.shape == (2, l // 2, 4, 5, 16)
    xt = _to_nchw(x, tdt)
    order = fusion_dma.pair_order(l)
    for pack in (fusion_dma.pack_pairs_ref, fusion_dma.pack_stack_ref, fusion_dma.pack_pairs_dma,
                 lambda z: fusion_dma.pack_index_select(z, order)):
        got = pack(xt)
        assert got.dtype == tdt, pack
        assert np.array_equal(got.float().permute(0, 1, 3, 4, 2).numpy(), want), pack


def test_split_conv_equals_pair_conv_and_the_labs_conv(jax_lab):
    rng = np.random.default_rng(0)
    n, c, s = 3, 4, 9
    alice, bob = (rng.standard_normal((n, s, s, c)).astype(np.float32) for _ in range(2))  # NHWC
    w0 = (rng.standard_normal((3, 3, 2 * c, 2 * c)) / 34).astype(np.float32)  # HWIO
    want = np.asarray(jax_lab.conv(jnp.concatenate([alice, bob], axis=-1), jnp.asarray(w0)))

    a, b = (torch.from_numpy(v).permute(0, 3, 1, 2) for v in (alice, bob))
    w = torch.from_numpy(w0).permute(3, 2, 0, 1)  # HWIO -> OIHW
    pair = F.conv2d(torch.cat([a, b], dim=1), w, padding=1)
    split = F.conv2d(a, w[:, :c], padding=1) + F.conv2d(b, w[:, c:], padding=1)
    scale = float(np.abs(want).max())
    assert float((pair - split).abs().max()) <= CONV_RTOL * scale
    assert np.abs(pair.permute(0, 2, 3, 1).numpy() - want).max() <= CONV_RTOL * scale


def test_lab_main_on_the_cpu_reports_and_writes_only_its_out(tmp_path, monkeypatch):
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    original = (REPO / "FUSION_LAB4.json").read_bytes()
    out = tmp_path / "report" / "lab.json"
    report = fusion_lab4.main(["--device", "cpu", "--out", str(out), "--batch", "2", "--views", "5",
                               "--size", "8", "--channels", "4", "--fwd-batches", "1", "2",
                               "--iters", "2", "--warmup", "1"])
    keys = {"pack_pallas", "pack_stack_xla", "pack_dma", "pack_ref", "pack_index_select",
            "pairconv", "splitconv", "fwd_bf16_batch1", "fwd_bf16_batch2"}
    assert keys <= set(report) and report["device"] == "cpu"
    assert report["pack_dma"]["correct"] is True and report["pack_dma"]["launches"] == 0
    assert report["splitconv"]["max_abs_diff"] <= 2.0 ** -6 * report["splitconv"]["max_abs_pair"]
    assert all(report[f"fwd_bf16_batch{b}"]["finite"] for b in (1, 2))
    assert all(report[k]["step_s"] > 0 for k in keys)
    assert json.loads(out.read_text()) == report
    assert [p.name for p in out.parent.iterdir()] == ["lab.json"] and not any(work.iterdir())
    assert (REPO / "FUSION_LAB4.json").read_bytes() == original
    assert fusion_lab4.DEFAULT_OUT == REPO / "build" / "fusion_lab4_torch.json"


def test_lab_cuda_request_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion_lab4.main(["--device", "cuda", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_k4_wrapper_refuses_cpu_and_misaligned_tensors():
    before = fusion_dma.LAUNCHES
    x = torch.randn(2, 5, 8, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fusion_dma.pack_pairs_dma_cuda(x)
    assert torch.equal(fusion_dma.pack_pairs_dma(x), fusion.pack_pairs_ref(x))
    assert fusion_dma.LAUNCHES == before
    assert fusion_dma.check_aligned(x) == 8 * 4 * 4 * 4
    with pytest.raises(ValueError, match="16-byte aligned"):  # 3*7*5*2 = 210-byte view blocks
        fusion_dma.check_aligned(torch.zeros((2, 5, 3, 7, 5), dtype=torch.bfloat16))
    flat = torch.zeros(2 * 5 * 8 * 4 * 4 + 1)
    shifted = flat[1:].view(2, 5, 8, 4, 4)  # 4 bytes past a 16-byte aligned base
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="base address % 16 = 4"):
        fusion_dma.check_aligned(shifted)


def test_k4_source_is_bulk_copies_without_atomics():
    src = (build.CSRC_DIR / "pack_pairs_dma.cu").read_text()
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    assert "cp.async.bulk.global.shared::cta.bulk_group" in src
    assert "examples/fusion_lab4.py::pack_dma" in src and "sm_90a" in src
    code = re.sub(r"//[^\n]*", "", src)  # the note says "no atomics"; the code has none
    assert not re.search(r"atom|red\.", code, re.I)
    assert re.search(r'extern "C" int hrn_pack_pairs_dma\(', src)
    assert build.SIGNATURES["hrn_pack_pairs_dma"] == build.SIGNATURES["hrn_pack_pairs"]


def test_pair_order_is_its_own_pack():
    order = fusion_dma.pair_order(6)
    assert order.tolist() == [0, 5, 1, 4, 2, 3]
    views = torch.arange(7.0).view(1, 7, 1, 1, 1)  # view v holds the value v
    got = fusion_dma.pack_index_select(views, fusion_dma.pair_order(7))
    assert got.flatten().tolist() == order.tolist()
