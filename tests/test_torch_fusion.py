"""Pair packing and its inverse: the port's plain versions against the JAX
package's XLA and Pallas (interpret-mode) versions and its custom VJP, the
dispatcher, the autograd Function, and the kernel build.

The CUDA kernels themselves run only on a card: their tests are in
``test_torch_cuda.py`` (``python3 chip_smoke.py`` checks them end to end).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.ops.fusion_pallas import _pallas_unpack, pack_pairs_pallas, pack_pairs_xla
from highresnet_tpu_torch.kernels import build
from highresnet_tpu_torch.ops import fusion

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _nhwc_input(l: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, l, 4, 5, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("l", [2, 4, 5, 8, 16])
def test_pack_pairs_ref_matches_jax(l, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _nhwc_input(l, seed=l)
    xj = jnp.asarray(x, jdt)
    want_xla = np.asarray(pack_pairs_xla(xj).astype(jnp.float32))
    want_pallas = np.asarray(pack_pairs_pallas(xj, interpret=True).astype(jnp.float32))

    xt = torch.from_numpy(x).to(tdt).permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> NCHW
    got = fusion.pack_pairs_ref(xt).float().permute(0, 1, 3, 4, 2).numpy()  # back to NHWC

    assert got.shape == (2, l // 2, 4, 5, 6)
    assert np.array_equal(got, want_xla)
    assert np.array_equal(got, want_pallas)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("l", [2, 5, 8])
def test_unpack_pairs_ref_matches_jax(l, dtype):
    """unpack_pairs_ref is bit-exact against the Pallas unpack (interpret
    mode, plus _bwd's zero block for an odd view) and against jax.vjp of
    the XLA pack."""
    jdt, tdt = DTYPES[dtype]
    half = l // 2
    g = np.random.default_rng(l).standard_normal((2, half, 4, 5, 6)).astype(np.float32)
    gj = jnp.asarray(g, jdt)
    want_pallas = _pallas_unpack(gj, interpret=True)
    if l > 2 * half:
        want_pallas = jnp.concatenate([want_pallas, jnp.zeros((2, 1, 4, 5, 3), jdt)], axis=1)
    x = jnp.zeros((2, l, 4, 5, 3), jdt)
    (want_vjp,) = jax.vjp(pack_pairs_xla, x)[1](gj)

    gt = torch.from_numpy(g).to(tdt).permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> NCHW
    got = fusion.unpack_pairs_ref(gt, l).float().permute(0, 1, 3, 4, 2).numpy()

    assert got.shape == (2, l, 4, 5, 3)
    assert np.array_equal(got, np.asarray(want_pallas.astype(jnp.float32)))
    assert np.array_equal(got, np.asarray(want_vjp.astype(jnp.float32)))


def test_pack_pairs_function_gradcheck():
    """PackPairs on the CPU runs the plain pack and unpack: its backward is
    the pack's true VJP."""
    for l in (2, 5, 8):
        x = torch.randn(2, l, 3, 4, 2, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(fusion.PackPairs.apply, (x,))


def test_dispatch_sends_cpu_tensors_to_the_plain_version():
    x = torch.randn(2, 5, 3, 4, 4, requires_grad=True)
    before = dict(fusion.LAUNCHES)
    got = fusion.pack_pairs(x)
    assert torch.equal(got, fusion.pack_pairs_ref(x))
    assert fusion.LAUNCHES == before
    got.sum().backward()  # the plain version differentiates on the CPU
    # every paired view gets gradient one; the odd fifth view is dropped
    assert torch.equal(x.grad[:, :4], torch.ones_like(x.grad[:, :4]))
    assert torch.equal(x.grad[:, 4], torch.zeros_like(x.grad[:, 4]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fusion.pack_pairs_cuda(x.detach())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fusion.unpack_pairs_cuda(got.detach(), 5)


def test_kernel_source_and_build_target_sm90a(tmp_path, monkeypatch):
    replaced = {
        "pack_pairs.cu": "fusion_pallas.py::_pack_kernel",
        "pack_pairs_dma.cu": "fusion_lab4.py::pack_dma",
        "unpack_pairs.cu": "fusion_pallas.py::_unpack_kernel",
        "lanczos_shift.cu": "lanczos_pallas.py::_fused_shift_kernel",
    }
    assert [p.name for p in build.sources()] == sorted(replaced)
    exported = set()
    for name, tpu_kernel in replaced.items():
        src = (build.CSRC_DIR / name).read_text()
        assert "sm_90a" in src and tpu_kernel in src, name
        exported |= set(re.findall(r'extern "C" int (\w+)\(', src))
    assert re.search(r'extern "C" int hrn_pack_pairs\(', (build.CSRC_DIR / "pack_pairs.cu").read_text())
    assert set(build.SIGNATURES) == exported
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in flags
    # the library name hashes the sources: it is stable and under build/kernels
    path = build.library_path()
    assert path == build.library_path()
    assert path.parent == build.BUILD_DIR and re.fullmatch(r"lib[0-9a-f]{16}\.so", path.name)
    # one nvcc per source (compile only), then one link of the objects
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    src = build.sources()[0]
    cmd = build.compile_command(src, tmp_path / "a.o")
    assert "-c" in cmd and "-shared" not in cmd and cmd[-1] == str(src)
    link = build.nvcc_command(tmp_path / "lib.so", [tmp_path / "a.o"])
    assert "-shared" in link and "-c" not in link
