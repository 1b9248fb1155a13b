"""K7: hybrid Newton-Schulz polar factor.

Replaces ``basd_tpu/ops/pallas/ns_polar.py:ns_polar_hybrid``
(``_ns_kernel``): an f32 Frobenius prescale, 5 accelerated quintic steps
(``QUINTIC_SCHEDULE``) and 2 cubic steps, bf16 operands with f32
accumulation and every intermediate rounded to bf16. For a CUDA tensor
one of the three CUDA kernels of ``csrc/ns_polar.cu`` runs, picked before
the launch from the shapes (``ns_polar_variant``): ``onchip``
(``basd_ns_polar_onchip``: the whole iteration in one CTA's shared memory
on wgmma, for r <= 192 where X and G fit), ``stream``
(``basd_ns_polar_stream``: one CTA a matrix with G in shared memory, X
streamed through it in 64-column chunks once a step; r <= 192 beyond the
on-chip limit) or ``batched`` (``basd_ns_polar_batched``: r > 192, each
product of each step one launch over every matrix on wgmma and a TMA
ring, X, G and H in a device-memory workspace). ``ns_polar_plain`` is the
same
function in plain PyTorch, taken for a CPU tensor. Forward-only: the polar
factor is the nuclear-norm subgradient, never differentiated through.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build

# the JAX package's schedule (basd_tpu/ops/pallas/ns_polar.py:34-40,
# equal to basd_tpu/ops/linalg.py:255-261), mirrored in csrc/ns_polar.cu
QUINTIC_SCHEDULE = (
    (4.0848, -6.8946, 2.9270),
    (3.9505, -6.3029, 2.6377),
    (3.7418, -5.5913, 2.3037),
    (2.8769, -3.1427, 1.2046),
    (2.8366, -3.0525, 1.2012),
)
NUM_CUBIC = 2


def _mm_nt(a, b):
    """(..., m, k) . (..., n, k)^T with f32 accumulation."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


def _mm_nn(a, b):
    return torch.matmul(a.float(), b.float())


def ns_polar_plain(x: torch.Tensor, inner_dtype: torch.dtype = torch.bfloat16,
                   quintic: tuple = QUINTIC_SCHEDULE,
                   num_cubic: int = NUM_CUBIC) -> torch.Tensor:
    """(..., r, c) -> polar factor in ``inner_dtype``: f32 Frobenius
    prescale, the ``quintic`` steps, then ``num_cubic`` cubic steps, every
    operand and intermediate rounded to ``inner_dtype``, f32 accumulation.
    With the defaults this is the TPU kernel's arithmetic."""
    x = x.float()
    norm2 = (x * x).sum(dim=(-2, -1), keepdim=True)
    xb = (x * torch.rsqrt(norm2 + 1e-30)).to(inner_dtype)
    for a, b, c in quintic:
        g = _mm_nt(xb, xb).to(inner_dtype)
        g2 = _mm_nt(g, g).to(inner_dtype)
        h = (b * g.float() + c * g2.float()).to(inner_dtype)
        xb = (a * xb.float() + _mm_nn(h, xb)).to(inner_dtype)
    for _ in range(num_cubic):
        xxt = _mm_nt(xb, xb).to(inner_dtype)
        xb = (1.5 * xb.float() - 0.5 * _mm_nn(xxt, xb)).to(inner_dtype)
    return xb


def polar_flops(b: int, r: int, c: int) -> int:
    """Operations of the iteration on ``b`` (r, c) matrices, as the function
    needs them: each quintic step G = X X^T and G G^T, both symmetric, so
    r (r + 1) / 2 dot products each (of length c and r), and H X; each
    cubic step X X^T and G X; two operations a multiply-add."""
    gram_x = r * (r + 1) * c
    gram_g = r * (r + 1) * r
    prod_x = 2 * r * r * c
    return b * (len(QUINTIC_SCHEDULE) * (gram_x + gram_g + prod_x)
                + NUM_CUBIC * (gram_x + prod_x))


def kernel_eligible(r: int, c: int) -> bool:
    """The JAX package's gate for its polar kernel (``linalg.py:296-305``),
    on the (rows, cols) of the wide orientation."""
    return r % 8 == 0 and c % 128 == 0


# a block's dynamic shared memory on sm_90, and the widest row padding
# (three warpgroups of 64 rows) of the on-chip variant
_SMEM_BYTES = 232448
_ONCHIP_MAX_ROWS = 192


def onchip_smem_bytes(rows_padded: int, c: int) -> int:
    """Shared memory of the on-chip variant (``csrc/ns_polar.cu``:
    ``onchip_smem_bytes``): alignment slack, X and G in bf16, one float a
    warp."""
    return 1024 + 2 * rows_padded * (c + rows_padded) + 4 * (2 * rows_padded // 32)


# columns of X a chunk of the streaming variant holds, and the chunks in
# its shared memory
_STREAM_COLS = 64
_STREAM_STAGES = 6


def stream_smem_bytes(rows_padded: int) -> int:
    """Shared memory of the streaming variant (``csrc/ns_polar.cu``:
    ``stream_smem_bytes``): alignment slack, G in bf16, the ring of
    ``_STREAM_STAGES`` chunks of 64 columns, one mbarrier a chunk, one
    float a warp."""
    return (1024 + 2 * rows_padded * rows_padded
            + _STREAM_STAGES * rows_padded * 2 * _STREAM_COLS
            + 8 * _STREAM_STAGES + 4 * (2 * rows_padded // 32))


def ns_polar_variant(r: int, c: int) -> str:
    """``onchip`` where X and G fit one block's shared memory with the rows
    padded to a multiple of 64 (at most 192, three warpgroups), else
    ``stream`` for rows padded to at most 192 and at least
    ``_STREAM_STAGES`` chunks of 64 columns, else ``batched``."""
    rp = -(-r // 64) * 64
    if rp <= _ONCHIP_MAX_ROWS and onchip_smem_bytes(rp, c) <= _SMEM_BYTES:
        return "onchip"
    if (rp <= _ONCHIP_MAX_ROWS and c % _STREAM_COLS == 0
            and c >= _STREAM_COLS * _STREAM_STAGES):
        return "stream"
    return "batched"


def batched_workspace_elems(r: int, c: int) -> int:
    """bf16 elements of the batched variant's workspace a matrix: X twice
    (the step's input and output), G and H."""
    return 2 * r * c + 2 * r * r


def _check_cuda_input(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ns_polar_hybrid: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("ns_polar_hybrid: x must be contiguous float32")
    if x.data_ptr() % 16:
        raise ValueError("ns_polar_hybrid: x must be 16-byte aligned")


def _launch_batched(x: torch.Tensor, out: torch.Tensor) -> None:
    """The batched variant from ``x`` into ``out``, X, G and H in a
    device-memory workspace of ``batched_workspace_elems`` bf16 a matrix."""
    b, r, c = x.shape
    ws = torch.empty((b, batched_workspace_elems(r, c)), dtype=torch.bfloat16,
                     device=x.device)
    _build.call("basd_ns_polar_batched", x.data_ptr(), out.data_ptr(),
                ws.data_ptr(), b, r, c, _build.stream_ptr(x.device))


# the parts of the streaming kernel (``csrc/ns_polar.cu``: ``StreamPart``)
STREAM_PARTS = {"io": 1, "io+products": 3, "io+traffic": 5, "all": 7}


def _launch_stream(x: torch.Tensor, out: torch.Tensor, parts: int) -> None:
    """The streaming kernel (``parts`` of it) from ``x`` into ``out``, its
    two copies of X in a workspace of 2 RP c bf16 a matrix."""
    b, r, c = x.shape
    rp = -(-r // 64) * 64
    ws = torch.empty((b, 2 * rp * c), dtype=torch.bfloat16, device=x.device)
    if parts == STREAM_PARTS["all"]:
        _build.call("basd_ns_polar_stream", x.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), b, r, c, _build.stream_ptr(x.device))
    else:
        _build.call("basd_ns_polar_stream_part", x.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), b, r, c, parts, _build.stream_ptr(x.device))


def ns_polar_hybrid(x: torch.Tensor) -> torch.Tensor:
    """Polar factor of ``x`` (B, r, c) f32, r <= c, r % 8 == 0,
    c % 128 == 0 (callers transpose tall inputs). Returns bf16."""
    if x.dim() != 3:
        raise ValueError(f"ns_polar_hybrid: expected (B, r, c), got {tuple(x.shape)}")
    b, r, c = x.shape
    if not (kernel_eligible(r, c) and r <= c):
        raise ValueError(
            f"ns_polar_hybrid: needs r <= c, r % 8 == 0, c % 128 == 0; got "
            f"{tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return ns_polar_plain(x)
    variant = ns_polar_variant(r, c)
    _check_cuda_input(x)
    out = torch.empty((b, r, c), dtype=torch.bfloat16, device=x.device)
    if variant == "batched":
        _launch_batched(x, out)
    elif variant == "stream":
        _launch_stream(x, out, STREAM_PARTS["all"])
    else:
        _build.call("basd_ns_polar_onchip", x.data_ptr(), out.data_ptr(), b,
                    r, c, _build.stream_ptr(x.device))
    ns_polar_hybrid.launches += 1
    ns_polar_hybrid.variants[variant] += 1
    return out


ns_polar_hybrid.launches = 0
# launches by variant
ns_polar_hybrid.variants = {"onchip": 0, "stream": 0, "batched": 0}


def ns_polar_stream_part(x: torch.Tensor, parts: str) -> torch.Tensor:
    """The streaming kernel with only some of its parts (``STREAM_PARTS``),
    at rows 129-192, to time them apart; counted nowhere. Only ``all``
    computes the polar factor."""
    b, r, c = x.shape
    if not (ns_polar_variant(r, c) == "stream" and r > 128):
        raise ValueError(f"ns_polar_stream_part: no streaming kernel at {(r, c)}")
    _check_cuda_input(x)
    out = torch.empty((b, r, c), dtype=torch.bfloat16, device=x.device)
    _launch_stream(x, out, STREAM_PARTS[parts])
    return out
