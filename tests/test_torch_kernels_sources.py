"""What the CUDA sources and their build promise, read from the files: no
kernel uses atomics (results stay deterministic), the build has no
fast-math (K3's in-kernel taps use IEEE ``sinf`` and divisions), and every
source exports the symbol its ctypes signature names."""

import re

import pytest

from highresnet_tpu_torch.kernels import build

SOURCES = sorted(p.name for p in build.sources() + build.headers())


def _code(name: str) -> str:
    src = (build.CSRC_DIR / name).read_text()
    return re.sub(r"//[^\n]*", "", src)  # notes may say "no atomics"; the code may not use one


@pytest.mark.parametrize("name", SOURCES)
def test_source_uses_no_atomics(name):
    assert "atomic" not in _code(name).lower()


def test_build_has_no_fast_math_and_exports_every_signature():
    flags = " ".join(build.COMPILE_FLAGS + build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    exported = "".join(_code(p.name) for p in build.sources())
    for symbol, argtypes in build.SIGNATURES.items():
        match = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', exported)
        assert match, symbol
        assert len(match.group(1).split(",")) == len(argtypes), symbol


def test_lanczos_kernel_takes_shifts_and_computes_its_taps():
    code = _code("lanczos_shift.cu")
    assert re.search(r"hrn_lanczos_shift\(const void\* img, const void\* shift, void\* out", code)
    assert "sinf(" in code and "__sinf" not in code
