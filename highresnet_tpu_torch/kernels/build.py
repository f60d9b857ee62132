"""Build the port's CUDA sources into one shared library and load it.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). Each
``csrc/*.cu`` compiles to an object in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links them. The library lands in
``<repo>/build/kernels/lib<hash>.so``, where the hash covers the sources,
the headers and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. It builds at first use; nothing here runs at
import time, so machines without ``nvcc`` can import the package.

Pointers and the stream cross the boundary as ``c_void_p``, sizes as
``c_int64``; every exported function returns ``cudaError_t`` as an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")  # the link step's flags

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# exported symbol -> ctypes argtypes
SIGNATURES = {
    # (x, out, batch, views, block_bytes, stream)
    "hrn_pack_pairs": (_P, _P, _I64, _I64, _I64, _P),
    # (x, out, batch, views, block_bytes, stream): K1's signature
    "hrn_pack_pairs_dma": (_P, _P, _I64, _I64, _I64, _P),
    # (g, out, batch, views, block_bytes, stream)
    "hrn_unpack_pairs": (_P, _P, _I64, _I64, _I64, _P),
    # (img, shift, out, batch, h, w, img_stride, stream)
    "hrn_lanczos_shift": (_P, _P, _P, _I64, _I64, _I64, _I64, _P),
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def compile_command(src: Path, obj: Path) -> list[str]:
    return [nvcc_path(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]


def nvcc_command(out: Path, objects: list[Path]) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *map(str, objects)]


def _run(procs: list[tuple[str, subprocess.Popen]]) -> None:
    failed = []
    for what, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{what} (exit {proc.returncode}):\n{err}{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        _run([
            (src.name, subprocess.Popen(compile_command(src, obj), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
            for src, obj in zip(sources(), objects)
        ])
        _run([("link", subprocess.Popen(nvcc_command(tmp, objects), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
