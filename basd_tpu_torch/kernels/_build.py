"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` into ONE shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. The library is built at first use into
``build/basd_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. ``nvcc``'s output (including ``-Xptxas -v`` register and spill
counts) is kept beside the library in ``nvcc.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "basd_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported entry points (see csrc/*.cu)
_SIGNATURES = {
    "basd_block_attn_fwd": (
        [_P] * 12 + [_I, _I, _I, _I, _F, _F, _P]
    ),
    "basd_block_mlp_collect_fwd": (
        [_P] * 12 + [_I, _I, _I, _I, _F, _P]
    ),
    "basd_ns_polar_hybrid": [_P, _P, _P, _I, _I, _I, _P],
}

_LIBRARY: list[ctypes.CDLL] = []


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
            "CUDA kernels are built from basd_tpu_torch/csrc at first use"
        )
    return found


def library_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libbasd_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if no build of the current sources exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if not _LIBRARY:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.basd_error_string.argtypes = [ctypes.c_int]
        lib.basd_error_string.restype = ctypes.c_char_p
        _LIBRARY.append(lib)
    return _LIBRARY[0]


def call(name: str, *args) -> None:
    """Call a kernel entry point; raise if any of its launches failed."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.basd_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
