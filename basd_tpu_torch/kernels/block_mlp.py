"""K2 and K4: the fused MLP halves of the teacher and the student.

K2 replaces ``basd_tpu/ops/pallas/fused_block_mlp.py:fused_ln_mlp_collect``
(``_fwd_collect_kernel``)::

    out = x + mask * fc2(gelu_tanh(fc1(LN2(x))))
    buf[idx*B*N:(idx+1)*B*N] = out          (in place)

The in-place write of the caller's flat (L*B*N, D) collection buffer takes
the place of the TPU kernel's ``input_output_aliases``. K4 replaces
``fused_ln_mlp``, the same function without the buffer and with a VJP: K4a
(``_fwd``) is K2's entry point called with no buffer, K4b (``_bwd``)
recomputes from x and returns dx and the f32 gradients of every parameter,
summed over the batch. ``FusedLnMlp`` wraps them as a
``torch.autograd.Function`` that saves only x, mask and the parameters.

The CUDA kernels (``csrc/block.cu``: ``basd_block_mlp_collect_fwd``;
``csrc/block_train.cu``: ``basd_block_mlp_bwd``) run for bf16 CUDA tensors,
their ``_f32`` twins for f32 ones (the reference's f32 Pallas kernels:
tanh-GELU, full-f32 CUDA-core GEMMs, no TF32), and raise on any other
dtype; the ``*_plain`` functions are the same arithmetic in plain PyTorch,
taken for CPU tensors. Rounding follows the TPU kernels: LN output, fc1
output and GELU output rounded to x's dtype, GELU in f32, fc2 output
rounded to x's dtype, mask and residual in f32, rounded once; the
backward's rounding points are listed at ``block_mlp_plain_bwd``. Weights
are in torch's (out, in) layout.

Tensor parallelism (``parallel.mesh.ModelParallel``): a rank holds F of
the hidden units, w1 (F, D) and w2 (D, F). The ``*_partial`` wrappers run
the same entries with ``partial`` set: the forward stops at the f32 sums
of fc2 over the rank's units (no b2, mask, residual or collection slab;
``fused_ln_mlp_collect_partial`` is the teacher's K2, ``fused_ln_mlp_fwd_partial``
the student's K4a, one entry, counted apart), the backward returns the f32
LN VJP of the rank's own dxn without do, and its LN-parameter sums.
``FusedLnMlpTP`` sums the shares over the model group and finishes the
block once (``block_attn.residual_add``); the teacher's caller writes the
finished output into the collection stack itself.

K2g is K2 for a SwiGLU MLP (DINOv2's ``SwiGLUFFN``, timm's
``SwiGLUPacked``), forward only, which no TPU kernel has::

    out = x + mask * fc2(silu(a) * g),   [a | g] = fc1(LN2(x))

with fc1 (2F, D) packed [a | g] and the same optional write into the
stack (``fused_ln_swiglu_collect``, ``csrc/block.cu:basd_block_swiglu_fwd``,
bf16 CUDA tensors only). The wrapper interleaves fc1's rows and bias in
groups of 64 (``swiglu_interleave``) so that one 128-wide tile of the fc1
product holds 64 units' a and g, paired in its epilogue. Rounding as K2's:
LN output; a and g each rounded after their bias, silu(a) * g in f32,
rounded once; fc2 output rounded; mask and residual in f32, rounded once
(``swiglu_mlp_plain``).

At bf16 the two forward products of K2 and K4a (and of every other
``launch_gemm_nk`` caller) take ``csrc/gemm_sm90.cuh``'s wgmma GEMM when
``gemm.gemm_nk_variant`` says so, and K4b's four backward products (dW2,
the GELU gradient, dW1, dxn) when ``gemm.gemm_bwd_variant`` says so; the
wrappers count the products of each variant in ``gemm_variants``.
``gemm_nk`` and ``gemm_bwd`` run one product on a chosen variant, for
holding the GEMMs against each other and timing them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.block_attn import (
    _ROW_CHUNK,
    _check,
    _mm,
    residual_add,
    split_flat,
)
from basd_tpu_torch.kernels.gemm import (
    count_products,
    gemm_bwd_variant,
    gemm_nk_variant,
    gemm_tile_m,
    split_k_chunk,
    weight_grad_floats,
)
from basd_tpu_torch.kernels.layernorm import (
    layernorm_plain_fwd,
    ln_stats_plain,
    ln_vjp_rows,
)

_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def gelu_tanh(p: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    t = torch.tanh(_GELU_C * (p + _GELU_A * p * p * p))
    return 0.5 * p * (1.0 + t)


def gelu_tanh_grad(p: torch.Tensor) -> torch.Tensor:
    """d/dp of ``gelu_tanh`` (``fused_mlp.py:_gelu_tanh_grad``)."""
    t = torch.tanh(_GELU_C * (p + _GELU_A * p * p * p))
    return 0.5 * (1.0 + t) + 0.5 * p * (1.0 - t * t) * _GELU_C * (
        1.0 + 3.0 * _GELU_A * p * p)


def block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-6):
    b, n, d = x.shape
    y = (block_mlp_plain_partial(x, ln_scale, ln_bias, w1, b1, w2, eps)
         + b2).to(x.dtype).float()
    m = mask.float().reshape(b, 1, 1)
    return (x.float() + y * m).to(x.dtype)


def block_mlp_plain_partial(x, ln_scale, ln_bias, w1, b1, w2,
                            eps: float = 1e-6):
    """The f32 sums of fc2 over w1's rows (a tensor-parallel rank's hidden
    units), no b2, mask or residual."""
    xnb = layernorm_plain_fwd(x, ln_scale, ln_bias, eps)[0]
    pre = (_mm(xnb, w1) + b1).to(x.dtype).float()
    h = gelu_tanh(pre).to(x.dtype)
    return _mm(h, w2)


def block_mlp_plain_bwd(x, mask, dout, ln_scale, ln_bias, w1, b1, w2,
                        eps: float = 1e-6, partial: bool = False):
    """Recompute backward of K4 (``fused_block_mlp.py:95-135``).

    Returns (dx in x.dtype, dw1 (F, D), db1, dw2 (D, F), db2, dln_scale,
    dln_bias), the gradients f32. Rounding points (to x's dtype, the
    identity at f32): the LN output, pre-activation and hidden; dy =
    do * mask with a rounded copy; dh = dyb W2 f32; dpre = dh gelu'(preb)
    f32 with a rounded copy into dW1 and dxn; dW2 from the rounded hidden
    and dy; the LN VJP per row f32; dx = round(do + dxln), or with
    ``partial`` (a tensor-parallel rank's hidden units) the f32 dxln alone.
    """
    dt = x.dtype
    xhat, _, rstd = ln_stats_plain(x, eps)
    xnb = (xhat * ln_scale.float() + ln_bias.float()).to(dt)
    pre = (_mm(xnb, w1) + b1).to(dt).float()
    hb = gelu_tanh(pre).to(dt)

    dof = dout.float()
    dy = dof * mask.float().reshape(-1, 1, 1)
    dyb = dy.to(dt).float()
    dh = torch.matmul(dyb, w2.float())
    dpre = dh * gelu_tanh_grad(pre)
    dpreb = dpre.to(dt).float()
    sum_bn = (0, 1)
    dw2 = torch.einsum("bnd,bnf->df", dyb, hb.float())
    dw1 = torch.einsum("bnf,bnd->fd", dpreb, xnb.float())
    dxn = torch.matmul(dpreb, w1.float())
    dxln = ln_vjp_rows(dxn, xhat, rstd, ln_scale)
    dx = dxln if partial else (dof + dxln).to(dt)
    return (dx, dw1, dpre.sum(sum_bn), dw2, dy.sum(sum_bn),
            (dxn * xhat).sum(sum_bn), dxn.sum(sum_bn))


def swiglu_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                     eps: float = 1e-6):
    """K2g's function in plain PyTorch: w1 (2F, D) packed [a | g] as timm
    and DINOv2 store it, rounded where the kernel rounds."""
    xnb = layernorm_plain_fwd(x, ln_scale, ln_bias, eps)[0]
    f = w2.shape[1]
    u = (_mm(xnb, w1) + b1).to(x.dtype).float()
    h = (F.silu(u[..., :f]) * u[..., f:]).to(x.dtype)
    y = (_mm(h, w2) + b2).to(x.dtype).float()
    m = mask.float().reshape(-1, 1, 1)
    return (x.float() + y * m).to(x.dtype)


# hidden units a group of K2g's interleaved fc1: half of its 128-wide tile
SWIGLU_GROUP = 64


def swiglu_interleave(t: torch.Tensor) -> torch.Tensor:
    """fc1's rows (or bias) packed [a | g] -> K2g's order: 64 units' a,
    their g, the next 64 units' a, ..."""
    f = t.shape[0] // 2
    grouped = t.reshape(2, f // SWIGLU_GROUP, SWIGLU_GROUP, *t.shape[1:])
    return grouped.transpose(0, 1).reshape(t.shape).contiguous()


def fused_ln_swiglu_collect(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                            buf=None, idx: int = 0, eps: float = 1e-6):
    """K2g: ``x + mask * fc2(silu(a) * g)``, [a | g] = fc1(LN(x)), (B, N, D)
    in x's dtype; with ``buf`` (L*B*N, D) it also writes ``out`` into rows
    ``[idx*B*N, (idx+1)*B*N)`` in place.

    x: bf16 on CUDA (any float dtype on the CPU, the plain version); mask:
    (B,) f32; w1 (2F, D) packed [a | g] and w2 (D, F) in x's dtype, F a
    multiple of 64; LN affine and biases f32."""
    b, n, d = x.shape
    m_rows = b * n
    if buf is not None:
        if buf.dim() != 2 or buf.shape[1] != d or buf.dtype != x.dtype:
            raise ValueError(
                f"collect buffer {tuple(buf.shape)}/{buf.dtype} does not "
                f"match block output {tuple(x.shape)}/{x.dtype}")
        if idx < 0 or (idx + 1) * m_rows > buf.shape[0]:
            raise ValueError(f"layer {idx} outside a {buf.shape[0]}-row stack")
    if x.device.type == "cpu":
        out = swiglu_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
        if buf is not None:
            buf[idx * m_rows:(idx + 1) * m_rows] = out.reshape(m_rows, d)
        return out
    f = w2.shape[1]
    if x.dtype != torch.bfloat16 or f % SWIGLU_GROUP:
        raise ValueError(f"fused_ln_swiglu_collect: bf16 with F % "
                         f"{SWIGLU_GROUP} == 0, got {x.dtype}, F={f}")
    extra = [("w1", w1, x.dtype, (2 * f, d)),
             ("b1", b1, torch.float32, (2 * f,))]
    if buf is not None:
        extra.append(("buf", buf, x.dtype, tuple(buf.shape)))
    _check_mlp("fused_ln_swiglu_collect", x, mask, ln_scale, ln_bias,
               w1[:f], b1[:f], w2, b2, *extra)
    out = torch.empty_like(x)
    ws_xn = torch.empty((m_rows, d), dtype=x.dtype, device=x.device)
    ws_h = torch.empty((m_rows, f), dtype=x.dtype, device=x.device)
    buf_rows = (0 if buf is None else
                buf.data_ptr() + idx * m_rows * d * buf.element_size())
    _build.call(
        "basd_block_swiglu_fwd", x.data_ptr(), mask.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(),
        swiglu_interleave(w1).data_ptr(), swiglu_interleave(b1).data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), buf_rows,
        ws_xn.data_ptr(), ws_h.data_ptr(), b, n, d, f, float(eps),
        _build.stream_ptr(x.device))
    fused_ln_swiglu_collect.launches += 1
    return out


fused_ln_swiglu_collect.launches = 0


def _check_mlp(name, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, *extra):
    """Shape, type and device checks of the CUDA path: x (B, N, D) bf16 or
    f32, the weights in x's dtype, mask, LN affine and biases f32;
    ``extra``: further (name, tensor, dtype, shape) inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _mlp_dims(name, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, *extra)


def _mlp_dims(name, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, *extra):
    """``_check_mlp``'s type and shape rules, on any device."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    dt, f32 = x.dtype, torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"{name}: x must be bf16 or f32, got {dt}")
    b, n, d = x.shape
    f = w1.shape[0]
    if d % 8 or f % 8:
        raise ValueError(f"{name}: D={d}, F={f} must be % 8")
    params = [("x", x, dt, (b, n, d)), ("mask", mask, f32, (b,)),
              ("ln_scale", ln_scale, f32, (d,)), ("ln_bias", ln_bias, f32, (d,)),
              ("w1", w1, dt, (f, d)), ("b1", b1, f32, (f,)),
              ("w2", w2, dt, (d, f)), *extra]
    if b2 is not None:
        params.append(("b2", b2, f32, (d,)))
    for pname, t, dtype, shape in params:
        _check(pname, t, dtype, shape)
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on x's device")


def _mlp_fwd_call(fn, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, buf_rows,
                  eps, partial: bool = False):
    """K2's entry (K4a's with no buffer; with ``partial`` fc2's f32 sums
    alone, mask and b2 None); counts the launch and the variants of its
    two products on the wrapper ``fn``."""
    b, n, d = x.shape
    f = w1.shape[0]
    out = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
           if partial else torch.empty_like(x))
    ws_xn = torch.empty((b * n, d), dtype=x.dtype, device=x.device)
    ws_h = torch.empty((b * n, f), dtype=x.dtype, device=x.device)
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    _build.call(
        _build.entry("basd_block_mlp_collect_fwd", x.dtype),
        x.data_ptr(), ptr(mask), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        ptr(b2), out.data_ptr(), buf_rows, ws_xn.data_ptr(),
        ws_h.data_ptr(), b, n, d, f, int(partial), float(eps),
        _build.stream_ptr(x.device),
    )
    fn.launches += 1
    for ptrs, n_out, k in (((ws_xn, w1, ws_h), f, d), ((ws_h, w2, out), d, f)):
        variant = gemm_nk_variant(x.dtype, n_out, k,
                                  [t.data_ptr() for t in ptrs])
        fn.gemm_variants[variant] += 1
    return out


def gemm_nk_plain(a, w, bias):
    """``a (M, K) . w (N, K)^T + bias`` rounded once to a's dtype."""
    return (_mm(a, w) + bias.float()).to(a.dtype)


def gemm_nk(a, w, bias, tile_n: int = -1):
    """One forward product through ``launch_gemm_nk``'s bias epilogue
    (``csrc/block.cu:basd_gemm_nk``): a (M, K), w (N, K) bf16 CUDA tensors,
    bias (N,) f32; ``tile_n`` -1 takes the rule's GEMM, 0 the WMMA tile,
    64 or 128 the sm90 GEMM at that tile width. For holding the two GEMMs
    against each other and timing them; no kernel path calls it."""
    m, k = a.shape
    n = w.shape[0]
    for pname, t, dtype, shape in (("a", a, torch.bfloat16, (m, k)),
                                   ("w", w, torch.bfloat16, (n, k)),
                                   ("bias", bias, torch.float32, (n,))):
        _check(pname, t, dtype, shape)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_nk: unsupported device {a.device}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _build.call("basd_gemm_nk", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                out.data_ptr(), m, n, k, tile_n, _build.stream_ptr(a.device))
    return out


# the epilogues of csrc/block_kernels.cuh that basd_gemm_bwd takes
_BWD_EPI = {"dgelu": 4, "f32": 5, "partial": 6, "round": 7}


def gemm_bwd_plain(a, b, epi: str, aux=None):
    """``gemm_bwd``'s function in plain PyTorch (f32 sums)."""
    if epi == "partial":
        return torch.matmul(a.float().t(), b.float())
    acc = torch.matmul(a.float(), b.float())
    if epi == "f32":
        return acc
    if epi == "round":
        return acc.to(a.dtype)
    d = acc * gelu_tanh_grad(aux.float())
    return d.to(a.dtype), d.sum(0)


def gemm_bwd(a, b, epi: str, aux=None, tile_n: int = -1, k_chunk: int = -1):
    """One backward product through ``launch_gemm_bwd``
    (``csrc/block.cu:basd_gemm_bwd``) on bf16 CUDA tensors, b (K, N):

    - ``'f32'``: a (M, K) . b in f32 (``input_grad``);
    - ``'round'``: the same rounded to bf16 (K11b's dx);
    - ``'dgelu'``: ``(bf16(d), d.sum(0))``, d = (a . b) * gelu'(aux), aux
      (M, N) (``dgelu_grad``);
    - ``'partial'``: a (K, M)^T . b in f32 through split-K partials of
      ``k_chunk`` rows (-1: ``gemm.split_k_chunk``'s), added in split order
      (``weight_grad``).

    ``tile_n`` -1 takes the rule's GEMM, 0 the WMMA tile, 64 or 128 the
    sm90 GEMM at that tile width. No kernel path calls it."""
    k = a.shape[0] if epi == "partial" else a.shape[1]
    m = a.shape[1] if epi == "partial" else a.shape[0]
    n = b.shape[1]
    bf = torch.bfloat16
    checks = [("a", a, bf, tuple(a.shape)), ("b", b, bf, (k, n))]
    if epi == "dgelu":
        checks.append(("aux", aux, bf, (m, n)))
    for pname, t, dtype, shape in checks:
        _check(pname, t, dtype, shape)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_bwd: unsupported device {a.device}")
    dev, f32 = a.device, torch.float32
    out = outf = part = None
    if epi in ("f32", "partial"):
        outf = torch.empty((m, n), dtype=f32, device=dev)
    if epi in ("round", "dgelu"):
        out = torch.empty((m, n), dtype=bf, device=dev)
    if epi == "dgelu":
        outf = torch.empty((n,), dtype=f32, device=dev)
        part = torch.empty((-(-m // 64) * n,), dtype=f32, device=dev)
    if epi == "partial":
        chunk = split_k_chunk(k, m, n) if k_chunk < 0 else k_chunk
        part = torch.empty((-(-k // max(chunk, 1)) * m * n,), dtype=f32,
                           device=dev)
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    _build.call("basd_gemm_bwd", a.data_ptr(), b.data_ptr(), ptr(aux),
                ptr(out), ptr(outf), ptr(part), m, n, k, _BWD_EPI[epi], tile_n,
                k_chunk, _build.stream_ptr(dev))
    if epi == "dgelu":
        return out, outf
    return out if epi == "round" else outf


def fused_ln_mlp_collect(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                         buf, idx: int, eps: float = 1e-6):
    """Returns ``out`` (B, N, D) and writes it into rows
    ``[idx*B*N, (idx+1)*B*N)`` of ``buf`` (L*B*N, D) in place; other rows
    are untouched.

    x, buf: bf16 or f32; mask: (B,) f32 stochastic-depth multipliers (ones
    for the deterministic teacher); w1: (F, D), w2: (D, F) in x's dtype; LN
    affine and biases f32.
    """
    b, n, d = x.shape
    m_rows = b * n
    if buf.dim() != 2 or buf.shape[1] != d or buf.dtype != x.dtype:
        raise ValueError(
            f"collect buffer {tuple(buf.shape)}/{buf.dtype} does not match "
            f"block output {tuple(x.shape)}/{x.dtype}"
        )
    if idx < 0 or (idx + 1) * m_rows > buf.shape[0]:
        raise ValueError(f"layer {idx} outside a {buf.shape[0]}-row stack")
    if x.device.type == "cpu":
        out = block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
        buf[idx * m_rows:(idx + 1) * m_rows] = out.reshape(m_rows, d)
        return out
    _check_mlp("fused_ln_mlp_collect", x, mask, ln_scale, ln_bias, w1, b1, w2,
               b2, ("buf", buf, x.dtype, tuple(buf.shape)))
    buf_rows = buf.data_ptr() + idx * m_rows * d * buf.element_size()
    return _mlp_fwd_call(fused_ln_mlp_collect, x, mask, ln_scale, ln_bias, w1,
                         b1, w2, b2, buf_rows, eps)


def fused_ln_mlp_fwd(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                     eps: float = 1e-6):
    """K4a: ``x + mask * fc2(gelu_tanh(fc1(LN(x))))`` (B, N, D) in x.dtype.

    x: bf16 or f32; mask: (B,) f32 stochastic-depth multipliers; w1:
    (F, D), w2: (D, F) in x's dtype; LN affine and biases f32.
    """
    if x.device.type == "cpu":
        return block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    _check_mlp("fused_ln_mlp_fwd", x, mask, ln_scale, ln_bias, w1, b1, w2, b2)
    return _mlp_fwd_call(fused_ln_mlp_fwd, x, mask, ln_scale, ln_bias, w1, b1,
                         w2, b2, None, eps)


def _mlp_partial(fn, x, ln_scale, ln_bias, w1, b1, w2, eps):
    if x.device.type == "cpu":
        return block_mlp_plain_partial(x, ln_scale, ln_bias, w1, b1, w2, eps)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    _check_mlp(fn.__name__, x, ones, ln_scale, ln_bias, w1, b1, w2, None)
    return _mlp_fwd_call(fn, x, None, ln_scale, ln_bias, w1, b1, w2, None,
                         None, eps, partial=True)


def fused_ln_mlp_collect_partial(x, ln_scale, ln_bias, w1, b1, w2,
                                 eps: float = 1e-6):
    """K2's share on a tensor-parallel rank of F (>= 1) hidden units (the
    teacher's; its caller writes the finished output into the stack):
    the f32 sums of fc2, (B, N, D), no b2, mask or residual."""
    return _mlp_partial(fused_ln_mlp_collect_partial, x, ln_scale, ln_bias,
                        w1, b1, w2, eps)


def fused_ln_mlp_fwd_partial(x, ln_scale, ln_bias, w1, b1, w2,
                             eps: float = 1e-6):
    """K4a's share on a tensor-parallel rank (the student's): as
    ``fused_ln_mlp_collect_partial``, counted apart."""
    return _mlp_partial(fused_ln_mlp_fwd_partial, x, ln_scale, ln_bias, w1,
                        b1, w2, eps)


def fused_ln_mlp_bwd(x, mask, dout, ln_scale, ln_bias, w1, b1, w2,
                     eps: float = 1e-6):
    """K4b: ``(dx in x's dtype, dw1, db1, dw2, db2, dln_scale,
    dln_bias)``, the gradients f32 and summed over the batch."""
    if x.device.type == "cpu":
        return block_mlp_plain_bwd(x, mask, dout, ln_scale, ln_bias, w1, b1,
                                   w2, eps)
    b, n, d = x.shape
    f32, dt = torch.float32, x.dtype
    _check_mlp("fused_ln_mlp_bwd", x, mask, ln_scale, ln_bias, w1, b1, w2,
               None, ("dout", dout, dt, (b, n, d)))
    dx = torch.empty_like(x)
    db2, dln_s, dln_b = (torch.empty((d,), dtype=f32, device=x.device)
                         for _ in range(3))
    dw1, db1, dw2 = _mlp_bwd_call(fused_ln_mlp_bwd, x, mask, dout, ln_scale,
                                  ln_bias, w1, b1, w2, dx, db2, dln_s, dln_b,
                                  False, eps)
    return dx, dw1, db1, dw2, db2, dln_s, dln_b


def fused_ln_mlp_bwd_partial(x, mask, dout, ln_scale, ln_bias, w1, b1, w2,
                             eps: float = 1e-6):
    """K4b's share on a tensor-parallel rank of F (>= 1) hidden units:
    ``(flat, dw1, db1, dw2)``, ``flat`` one f32 buffer of the rank's dxln
    (B*N*D, without do) and its LN-parameter sums (D, D), for one
    all-reduce (``split_flat(flat, (B, N, D), (D,), (D,))``); db2 is the
    caller's."""
    b, n, d = x.shape
    if x.device.type == "cpu":
        dx, dw1, db1, dw2, _, dls, dlb = block_mlp_plain_bwd(
            x, mask, dout, ln_scale, ln_bias, w1, b1, w2, eps, partial=True)
        return torch.cat([dx.reshape(-1), dls, dlb]), dw1, db1, dw2
    _check_mlp("fused_ln_mlp_bwd_partial", x, mask, ln_scale, ln_bias, w1, b1,
               w2, None, ("dout", dout, x.dtype, (b, n, d)))
    flat = torch.empty((b * n * d + 2 * d,), dtype=torch.float32,
                       device=x.device)
    dx, dln_s, dln_b = split_flat(flat, (b, n, d), (d,), (d,))
    dw1, db1, dw2 = _mlp_bwd_call(fused_ln_mlp_bwd_partial, x, mask, dout,
                                  ln_scale, ln_bias, w1, b1, w2, dx, None,
                                  dln_s, dln_b, True, eps)
    return flat, dw1, db1, dw2


def _mlp_bwd_call(fn, x, mask, dout, ln_scale, ln_bias, w1, b1, w2, dx, db2,
                  dln_s, dln_b, partial, eps):
    """K4b's entry on checked inputs (``partial``: the f32 dxln into dx, db2
    None); counts the launch and its products on ``fn``. Returns (dw1, db1,
    dw2)."""
    b, n, d = x.shape
    f = w1.shape[0]
    f32, dt = torch.float32, x.dtype
    m = b * n
    dev = x.device
    chunks = -(-m // _ROW_CHUNK)
    dw1 = torch.empty((f, d), dtype=f32, device=dev)
    db1 = torch.empty((f,), dtype=f32, device=dev)
    dw2 = torch.empty((d, f), dtype=f32, device=dev)
    ws_xn, ws_dyb = (torch.empty((m, d), dtype=dt, device=dev)
                     for _ in range(2))
    ws_pre, ws_h, ws_dpre = (torch.empty((m, f), dtype=dt, device=dev)
                             for _ in range(3))
    ws_stats = torch.empty((2 * m,), dtype=f32, device=dev)
    ws_f32 = torch.empty((m, d), dtype=f32, device=dev)
    # the GELU-gradient product writes one column-sum row per row tile of
    # its variant (a fresh workspace is aligned: it does not enter the rule)
    dgelu = gemm_bwd_variant(dt, (d, f), [t.data_ptr() for t in
                                          (ws_dyb, w2, ws_dpre, ws_pre)])
    ws_part = torch.empty(
        (max(weight_grad_floats(m, ((d, f), (f, d))),
             -(-m // gemm_tile_m(dgelu)) * f, 2 * chunks * d),),
        dtype=f32, device=dev)
    _build.call(
        _build.entry("basd_block_mlp_bwd", dt),
        x.data_ptr(), mask.data_ptr(), dout.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
        0 if db2 is None else db2.data_ptr(), dln_s.data_ptr(),
        dln_b.data_ptr(), ws_xn.data_ptr(),
        ws_stats.data_ptr(), ws_pre.data_ptr(), ws_h.data_ptr(),
        ws_dyb.data_ptr(), ws_dpre.data_ptr(), ws_f32.data_ptr(),
        ws_part.data_ptr(), b, n, d, f, _ROW_CHUNK, int(partial), float(eps),
        _build.stream_ptr(dev),
    )
    fn.launches += 1
    # dW2 = dyb^T h, dpre = (dyb W2) gelu'(pre), dW1 = dpre^T xn, dxn =
    # dpre W1 (csrc/block_train.cu)
    count_products(fn, dt, (
        ((d, f), (ws_dyb, ws_h, ws_part)),
        ((d, f), (ws_dyb, w2, ws_dpre, ws_part, ws_pre)),
        ((f, d), (ws_dpre, ws_xn, ws_part)),
        ((f, d), (ws_dpre, w1, ws_f32))))
    return dw1, db1, dw2


# forward products by GEMM variant (gemm.gemm_nk_variant), two a launch;
# K4b's backward products (gemm.gemm_bwd_variant), four a launch
for _fn in (fused_ln_mlp_collect, fused_ln_mlp_fwd, fused_ln_mlp_bwd,
            fused_ln_mlp_collect_partial, fused_ln_mlp_fwd_partial,
            fused_ln_mlp_bwd_partial):
    _fn.launches = 0
    _fn.gemm_variants = {"sm90": 0, "wmma": 0, "f32": 0}


class FusedLnMlp(torch.autograd.Function):
    """K4a forward, K4b backward; the mask is not differentiated."""

    @staticmethod
    def forward(ctx, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        out = fused_ln_mlp_fwd(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mask, ln_s, ln_b, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dls, dlb = fused_ln_mlp_bwd(
            x, mask, dout.to(x.dtype).contiguous(), ln_s, ln_b, w1, b1, w2,
            ctx.eps)
        return (dx, None, dls.to(ln_s.dtype), dlb.to(ln_b.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None)


def fused_ln_mlp(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                 eps: float = 1e-6):
    """``x + mask * fc2(gelu_tanh(fc1(LN(x))))``, differentiable (K4a/K4b)."""
    return FusedLnMlp.apply(x.contiguous(), mask, ln_scale, ln_bias, w1, b1,
                            w2, b2, eps)


def _mlp_share(partial_fn, x, ln_scale, ln_bias, w1, b1, w2, eps):
    """A rank's fc2 sums (zeros, and no launch, for a rank without hidden
    units)."""
    if w1.shape[0]:
        return partial_fn(x, ln_scale, ln_bias, w1, b1, w2, eps)
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def fused_ln_mlp_collect_tp(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, buf,
                            idx: int, eps: float, reduce_):
    """The teacher's MLP half on a tensor-parallel rank (forward only): K2's
    share summed over the model group in place by ``reduce_``, the block
    finished once (``residual_add``) and written into rows
    ``[idx*B*N, (idx+1)*B*N)`` of the stack ``buf``."""
    acc = _mlp_share(fused_ln_mlp_collect_partial, x, ln_scale, ln_bias, w1,
                     b1, w2, eps)
    reduce_(acc)
    out = residual_add(x, mask, acc, b2)
    m = out.shape[0] * out.shape[1]
    buf[idx * m:(idx + 1) * m] = out.reshape(m, out.shape[-1])
    return out


class FusedLnMlpTP(torch.autograd.Function):
    """The student's MLP half on a tensor-parallel rank: K4a's share summed
    over the model group (``reduce_``, in place), then ``residual_add``;
    backward: K4b's share (dxln and the LN-parameter sums in one buffer)
    summed the same way, dx = x's dtype of do + the sum, db2 the sum of
    do * mask (the same bits on every rank). A rank without hidden units
    launches nothing and contributes zeros."""

    @staticmethod
    def forward(ctx, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                reduce_):
        acc = _mlp_share(fused_ln_mlp_fwd_partial, x, ln_scale, ln_bias, w1,
                         b1, w2, eps)
        reduce_(acc)
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, w1, b1, w2)
        ctx.eps, ctx.reduce_ = eps, reduce_
        return residual_add(x, mask, acc, b2)

    @staticmethod
    def backward(ctx, dout):
        x, mask, ln_s, ln_b, w1, b1, w2 = ctx.saved_tensors
        b, n, d = x.shape
        dout = dout.to(x.dtype).contiguous()
        if w1.shape[0]:
            flat, dw1, db1, dw2 = fused_ln_mlp_bwd_partial(
                x, mask, dout, ln_s, ln_b, w1, b1, w2, ctx.eps)
        else:
            flat = torch.zeros((b * n * d + 2 * d,), dtype=torch.float32,
                               device=x.device)
            dw1, db1, dw2 = (torch.zeros(t.shape, dtype=torch.float32,
                                         device=x.device) for t in (w1, b1, w2))
        ctx.reduce_(flat)
        dxln, dls, dlb = split_flat(flat, (b, n, d), (d,), (d,))
        dy = dout.float() * mask.float().reshape(-1, 1, 1)
        dx = (dout.float() + dxln).to(x.dtype)
        return (dx, None, dls.to(ln_s.dtype), dlb.to(ln_b.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                dy.sum((0, 1)), None, None)


def fused_ln_mlp_tp(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                    reduce_):
    """``x + mask * fc2(gelu_tanh(fc1(LN(x))))`` on a tensor-parallel rank,
    differentiable (``FusedLnMlpTP``)."""
    return FusedLnMlpTP.apply(x.contiguous(), mask, ln_scale, ln_bias, w1, b1,
                              w2, b2, eps, reduce_)
