"""K6: the selector's layer mix, ``mixed[p] = sum_l w[p, l] * t[l]``, and
its weight gradient, in Triton.

Replaces ``basd_tpu/ops/pallas/mix_stack.py``: the forward
``_mix_fwd_pallas`` (``_mix_kernel``) and the backward ``_dw_pallas``
(``_dw_kernel``), ``dw[p, l] = <g[p], t[l]>``.

What bounds it on the H100: both halves are pure bandwidth passes over the
(L, M, D) packed teacher stack (12 x 25216 x 384 bf16 = 233 MB at B=128):
the contraction depth is L = 12, so there is no tensor-core work, and the
floor is the stack read plus the (P, M, D) panel (~0.1 ms at 3.35 TB/s).
The forward reads every stack element once in its native layout and keeps
the P accumulators in f32 registers. The TPU kernel carries the dw sum
across a sequential grid in SMEM; Hopper's blocks run in no order, so
each program writes its (P, L) partial sums to a (tiles, P, L) f32 scratch
and a second pass sums the scratch in a fixed order (deterministic, no
atomics).

``mix_stack`` is a ``torch.autograd.Function``; ``t`` is always the
stop-gradient teacher stack, so its cotangent is ``None``. The dispatch
(``kernel_eligible``) sends a CUDA stack of ``M % 8 == 0`` to the kernels
whatever L and D: the JAX package's further ``L * D <= 32768`` is the TPU
kernel's VMEM, and these programs stream the L layers one at a time
through registers (a (P, 1024) f32 accumulator), so a DINOv2 ViT-g/14
stack (L * D = 61,440) takes them too. Each program steps a pointer from
layer to layer: the flat offset l * M * D passes 2^31 in that stack (4.0e9
elements at B=256), which a 32-bit index product would wrap. Other stacks
take the plain einsum, which upcasts the whole stack to f32; CPU tensors
always do. With the program tracer on, each forward counts its route in
``mix.calls.kernel`` or ``mix.calls.plain``.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.utils import trace

_BLOCK = 1024  # stack elements per program along the flat (M*D) axis
_REDUCE_BLOCK = 1024
_TRITON: dict = {}


def _kernels() -> dict:
    """Compile-on-first-use Triton kernels (triton imports only here)."""
    if _TRITON:
        return _TRITON
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def mix_fwd_kernel(w_ptr, t_ptr, o_ptr, n, num_p,
                       P_PAD: tl.constexpr, L: tl.constexpr,
                       BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        valid = offs < n
        prow = tl.arange(0, P_PAD)
        pmask = prow < num_p
        acc = tl.zeros((P_PAD, BLOCK), dtype=tl.float32)
        t_l = t_ptr + offs  # layer l's elements: a pointer stepped by n
        for l in tl.static_range(L):
            tl_l = tl.load(t_l, mask=valid, other=0.0)
            w_l = tl.load(w_ptr + prow * L + l, mask=pmask, other=0.0)
            acc += w_l[:, None] * tl_l.to(tl.float32)[None, :]
            t_l += n
        out_ptrs = o_ptr + prow[:, None] * n + offs[None, :]
        tl.store(out_ptrs, acc.to(o_ptr.dtype.element_ty),
                 mask=pmask[:, None] & valid[None, :])

    @triton.jit
    def mix_dw_partial_kernel(g_ptr, t_ptr, part_ptr, n, num_p,
                              P_PAD: tl.constexpr, L: tl.constexpr,
                              BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        valid = offs < n
        prow = tl.arange(0, P_PAD)
        pmask = prow < num_p
        g = tl.load(g_ptr + prow[:, None] * n + offs[None, :],
                    mask=pmask[:, None] & valid[None, :], other=0.0)
        g = g.to(tl.float32)
        t_l = t_ptr + offs
        for l in tl.static_range(L):
            tl_l = tl.load(t_l, mask=valid, other=0.0)
            part = tl.sum(g * tl_l.to(tl.float32)[None, :], axis=1)
            tl.store(part_ptr + pid * num_p * L + prow * L + l, part,
                     mask=pmask)
            t_l += n

    @triton.jit
    def mix_dw_reduce_kernel(part_ptr, dw_ptr, num_tiles, num_pl,
                             BLOCK: tl.constexpr):
        j = tl.program_id(0)  # one (p, l) pair per program
        acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for start in range(0, num_tiles, BLOCK):
            rows = start + tl.arange(0, BLOCK)
            acc += tl.load(part_ptr + rows * num_pl + j, mask=rows < num_tiles,
                           other=0.0)
        tl.store(dw_ptr + j, tl.sum(acc, axis=0))

    _TRITON.update(fwd=mix_fwd_kernel, dw_partial=mix_dw_partial_kernel,
                   dw_reduce=mix_dw_reduce_kernel)
    return _TRITON


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _p_pad(num_p: int) -> int:
    return 1 << max(0, (num_p - 1).bit_length())


def mix_fwd_plain(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(P, L) x (L, ...) -> (P, ...) in t.dtype, f32 accumulation."""
    return torch.einsum("pl,l...->p...", w.float(), t.float()).to(t.dtype)


def mix_dw_plain(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(P, M, D) x (L, M, D) -> (P, L) f32."""
    return torch.einsum("pmd,lmd->pl", g.float(), t.float())


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on {dev}")


def mix_stack_fwd(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward of K6: (P, L) weights x (L, M, D) stack -> (P, M, D)."""
    if t.device.type == "cpu":
        return mix_fwd_plain(w, t)
    num_l, m, d = t.shape
    num_p = w.shape[0]
    if w.shape != (num_p, num_l):
        raise ValueError(f"mix_stack_fwd: w {tuple(w.shape)} vs L={num_l}")
    w32 = w.float().contiguous()
    _check_cuda("mix_stack_fwd", t, w32)
    out = torch.empty((num_p, m, d), dtype=t.dtype, device=t.device)
    n = m * d
    grid = (_cdiv(n, _BLOCK),)
    _kernels()["fwd"][grid](w32, t, out, n, num_p,
                            P_PAD=_p_pad(num_p), L=num_l, BLOCK=_BLOCK)
    mix_stack_fwd.launches += 1
    return out


def mix_stack_dw(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """dL/dw of K6: (P, M, D) cotangent x (L, M, D) stack -> (P, L) f32."""
    if t.device.type == "cpu":
        return mix_dw_plain(g, t)
    num_l, m, d = t.shape
    num_p = g.shape[0]
    if tuple(g.shape) != (num_p, m, d):
        raise ValueError(f"mix_stack_dw: g {tuple(g.shape)} vs t {tuple(t.shape)}")
    _check_cuda("mix_stack_dw", t, g)
    n = m * d
    tiles = _cdiv(n, _BLOCK)
    part = torch.empty((tiles, num_p, num_l), dtype=torch.float32,
                       device=t.device)
    dw = torch.empty((num_p, num_l), dtype=torch.float32, device=t.device)
    k = _kernels()
    k["dw_partial"][(tiles,)](g, t, part, n, num_p, P_PAD=_p_pad(num_p),
                              L=num_l, BLOCK=_BLOCK)
    k["dw_reduce"][(num_p * num_l,)](part, dw, tiles, num_p * num_l,
                                     BLOCK=_REDUCE_BLOCK)
    mix_stack_dw.launches += 1
    return dw


mix_stack_fwd.launches = 0
mix_stack_dw.launches = 0


def kernel_eligible(shape, cuda: bool) -> bool:
    """Whether an (L, M, D) stack of ``shape`` takes K6: on CUDA with
    ``M % 8 == 0`` (the JAX package's gate, ``mix_stack.py:101-109``,
    without its TPU-only ``L * D <= 32768``)."""
    return cuda and len(shape) == 3 and shape[1] % 8 == 0


class MixStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, t):
        ctx.save_for_backward(w, t)
        kernel = kernel_eligible(t.shape, t.is_cuda)
        trace.count("mix.calls.kernel" if kernel else "mix.calls.plain")
        if kernel:
            return mix_stack_fwd(w, t)
        return mix_fwd_plain(w, t)

    @staticmethod
    def backward(ctx, g):
        w, t = ctx.saved_tensors
        g = g.contiguous()
        if (kernel_eligible(t.shape, t.is_cuda)
                and g.shape == (w.shape[0],) + tuple(t.shape[1:])):
            dw = mix_stack_dw(g, t)
        else:
            dw = mix_dw_plain(g, t)
        return dw.to(w.dtype), None


def mix_stack(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(P, L) weights x (L, M, D) stack -> (P, M, D) mixed panel; ``t`` is
    treated as constant (no gradient)."""
    return MixStack.apply(w, t)
