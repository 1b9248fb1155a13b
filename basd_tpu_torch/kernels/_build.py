"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc``, one process per source
started together, and link into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. The library is built at first use into
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported entry points (see csrc/*.cu)
_SIGNATURES = {
    "basd_block_attn_fwd": (
        [_P] * 12 + [_I] * 7 + [_F, _F, _P]
    ),
    "basd_block_mlp_collect_fwd": (
        [_P] * 12 + [_I] * 5 + [_F, _P]
    ),
    "basd_block_swiglu_fwd": [_P] * 12 + [_I] * 4 + [_F, _P],
    "basd_block_attn_train_fwd": (
        [_P] * 12 + [_I] * 6 + [_F, _F, _P]
    ),
    "basd_block_attn_train_bwd": (
        [_P] * 25 + [_I] * 7 + [_F, _F, _P]
    ),
    "basd_block_mlp_bwd": (
        [_P] * 23 + [_I] * 6 + [_F, _P]
    ),
    "basd_flash_attn_fwd": [_P] * 3 + [_I] * 4 + [_F, _P],
    "basd_flash_attn_imp": [_P] * 4 + [_I] * 4 + [_F, _P],
    "basd_flash_attn_bwd": [_P] * 6 + [_I] * 4 + [_F, _P],
    "basd_gemm_nk": [_P] * 4 + [_I] * 4 + [_P],
    "basd_gemm_bwd": [_P] * 6 + [_I] * 6 + [_P],
    "basd_layernorm_fwd": [_P] * 6 + [_I, _I, _F, _I, _P],
    "basd_fused_mlp_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "basd_fused_mlp_bwd": [_P] * 14 + [_I] * 6 + [_P],
    "basd_ns_polar_onchip": [_P, _P, _I, _I, _I, _P],
    "basd_ns_polar_stream": [_P, _P, _P, _I, _I, _I, _P],
    "basd_ns_polar_stream_part": [_P, _P, _P, _I, _I, _I, _I, _P],
    "basd_ns_polar_batched": [_P, _P, _P, _I, _I, _I, _P],
    "basd_jacobi_rounds": [_P] * 5 + [_I] * 4 + [_P],
    "basd_jacobi_vectors": [_P] * 3 + [_I] * 3 + [_P],
    "basd_ceigh_plan": [_I] * 3 + [_P],
    "basd_ceigh": [_P] * 4 + [_I] * 3 + [_P],
    "basd_geom_shift3": [_P] * 6 + [_I] * 7 + [_P],
}
# the f32 twins of K2/K4's, K5a's, K10's and K11's entries take the same
# arguments
_SIGNATURES.update({
    name + "_f32": _SIGNATURES[name]
    for name in ("basd_block_mlp_collect_fwd", "basd_block_mlp_bwd",
                 "basd_layernorm_fwd",
                 "basd_flash_attn_fwd", "basd_flash_attn_imp",
                 "basd_flash_attn_bwd", "basd_fused_mlp_fwd",
                 "basd_fused_mlp_bwd")
})

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


def _run(cmds: list[list[str]], log: list[str]) -> None:
    """Run the commands concurrently; log their output, raise on failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]}: exit code {proc.returncode}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the library if no build of the current sources exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    nvcc = _nvcc()
    log: list[str] = []
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objects)], log)
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objects)]], log)
    finally:
        (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
        for obj in objects:
            obj.unlink(missing_ok=True)
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


def entry(name: str, dtype) -> str:
    """The entry point of ``name`` for tensors of ``dtype``: its ``_f32``
    twin at torch.float32, ``name`` itself otherwise."""
    import torch

    return name + ("_f32" if dtype == torch.float32 else "")


def stream_ptr(device) -> int:
    """The raw handle of the current CUDA stream of ``device`` (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
