"""K1 and K3: the fused attention halves of the teacher and the student.

K1 replaces ``basd_tpu/ops/pallas/fused_block_attn.py:fused_block_attn``
(``_fwd_kernel``)::

    out = x + proj(MHSA(LN1(x) W_qkv + b_qkv))  (+ head-mean CLS-row importance)

forward-only: the teacher is frozen. K3 replaces
``fused_block_attn_train``, the student's differentiable sibling with a
per-image stochastic-depth multiplier::

    out = x + mask * proj(MHSA(LN1(x) W_qkv + b_qkv))

K3a (``_fwd_train``) also returns the per-(image, head, query)
logsumexp; K3b (``_bwd_train``) recomputes the block from x and lse and
returns dx and the f32 gradients of every parameter, summed over the
batch. ``FusedBlockAttnTrain`` wraps them as a ``torch.autograd.Function``
that saves only x, mask, the parameters and lse.

The CUDA kernels (``csrc/block.cu``: ``basd_block_attn_fwd``,
``basd_block_attn_train_fwd``; ``csrc/block_train.cu``:
``basd_block_attn_train_bwd``) run for CUDA tensors; the ``*_plain``
functions are the same arithmetic in plain PyTorch, taken for CPU
tensors. All round where the TPU kernels round: f32 LN statistics, bf16 LN
output, qkv accumulated in f32 and rounded to bf16, per-head f32 softmax
with bf16 probabilities into P.V and deferred normalisation, proj
accumulated in f32 and rounded to bf16, residual (times the mask) added in
f32 and rounded once; the backward's rounding points are listed at
``block_attn_train_plain_bwd``. Weights are in torch's (out, in) layout.

Tensor parallelism (``parallel.mesh.ModelParallel``): a rank holds
``num_heads`` of the block's ``heads_total`` heads of width ``head_dim``,
so its w_qkv is (3 h E, D) and its w_proj (D, h E). The ``*_partial``
wrappers (K1, K3a, K3b) run the same CUDA entries with ``partial`` set:
K1 and K3a stop at the f32 sums of proj over the rank's heads, without
bias, mask or residual (K1's importance: its heads' CLS rows over
``l * heads_total``), K3b returns the f32 LN VJP of the rank's own dxn
without the residual's do, and its LN-parameter sums; each counts its own
launches. ``fused_block_attn_tp`` and ``FusedBlockAttnTrainTP`` sum those
shares over the model group and finish the block once, as the whole
kernel's epilogue rounds it: ``bf16(x + mask * bf16(sum + b_proj))``;
the backward adds do once to the summed VJP. A rank with no head
launches nothing and contributes zeros.

The attention of K1 and K3a is the forward attention core of
``csrc/attention.cuh``, which K10a and K10c share: ``attn_fwd_variant``
says which of its two kernels a slab takes (the tensor-core kernel for bf16
with a head width E % 16 == 0, 16 <= E <= 128; the CUDA-core kernel for
any other even E and for f32), ``_attn_fwd_smem`` the shared memory it
needs. K3b's attention is the backward core of ``csrc/attention_bwd.cuh``,
which K10b shares, with the same rule (``attn_bwd_variant``) and two
launches of either variant (``_attn_bwd_smem``). Each of the six wrappers
counts its launches of each variant in ``tc_launches`` and
``simt_launches`` beside ``launches``. K3b also counts its four backward
products (dattn, dW_proj, dW_qkv, dxn) by GEMM variant in
``gemm_variants`` (``gemm.gemm_bwd_variant``).
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.gemm import count_products, weight_grad_floats
from basd_tpu_torch.kernels.layernorm import (
    layernorm_plain_fwd,
    ln_stats_plain,
    ln_vjp_rows,
)

_SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared-memory limit
_ROW_CHUNK = 256  # rows per partial of the backward's column sums


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: ``a @ w.T`` in f32."""
    return torch.matmul(a.float(), w.float().t())


def _heads(t, num_heads):
    """(B, N, H*E) -> (B, H, N, E)."""
    b, n, d = t.shape
    return t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(t):
    """(B, H, N, E) -> (B, N, H*E)."""
    b, h, n, e = t.shape
    return t.transpose(1, 2).reshape(b, n, h * e)


def _attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, num_heads, eps,
                     head_dim=None):
    """LN, qkv and per-head softmax attention of ``num_heads`` heads of
    ``head_dim`` (default D / num_heads) with deferred normalisation:
    returns (attn (B, N, H E) in x.dtype, unnormalised p, row max m, row
    sum l), the last three f32 (B, H, N, N | 1)."""
    e = head_dim or x.shape[-1] // num_heads
    scale = float(e) ** -0.5
    xnb = layernorm_plain_fwd(x, ln_scale, ln_bias, eps)[0]
    qkv = (_mm(xnb, w_qkv) + b_qkv).to(x.dtype)
    q, k, v = (_heads(t, num_heads) for t in
               qkv.split(num_heads * e, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(x.dtype).float(), v.float()) / l
    return _merge_heads(o.to(x.dtype)), p, m, l


def block_attn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int, eps: float = 1e-6):
    acc, imp = block_attn_plain_partial(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                        w_proj, num_heads, None, num_heads,
                                        eps)
    y = (acc + b_proj).to(x.dtype).float()
    return (x.float() + y).to(x.dtype), imp


def block_attn_plain_partial(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             num_heads: int, head_dim, heads_total: int,
                             eps: float = 1e-6):
    """K1's share on a tensor-parallel rank of ``num_heads`` heads:
    ``(proj sums (B, N, D) f32, importance (B, N) f32)``, the CLS rows
    over ``l * heads_total`` added in head order."""
    attn, p, _, l = _attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                     num_heads, eps, head_dim)
    row0 = p[:, :, 0, :] / (l[:, :, 0] * heads_total)  # (B, H, N)
    imp = row0[:, 0]
    for i in range(1, num_heads):
        imp = imp + row0[:, i]
    return _mm(attn, w_proj), imp


def residual_add(x, mask, acc, bias):
    """``x + mask * (acc + bias)`` as the block kernels' epilogue rounds
    it: the sum with the bias rounded to x's dtype, then mask and residual
    in f32, rounded once; ``mask`` None means 1."""
    y = (acc + bias).to(x.dtype).float()
    if mask is not None:
        y = y * mask.float().reshape(-1, 1, 1)
    return (x.float() + y).to(x.dtype)


def block_attn_train_plain_fwd(x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                               w_proj, b_proj, num_heads: int,
                               eps: float = 1e-6):
    """Returns (out (B, N, D) in x.dtype, lse (B, H, N) f32)."""
    acc, lse = block_attn_train_plain_fwd_partial(
        x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, num_heads, None, eps)
    y = (acc + b_proj).to(x.dtype).float()
    out = (x.float() + y * mask.float().reshape(-1, 1, 1)).to(x.dtype)
    return out, lse


def block_attn_train_plain_fwd_partial(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_proj, num_heads: int, head_dim,
                                       eps: float = 1e-6):
    """K3a's share on a tensor-parallel rank: ``(proj sums (B, N, D) f32,
    lse (B, H, N) f32)`` of its ``num_heads`` heads."""
    attn, _, m, l = _attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                     num_heads, eps, head_dim)
    return _mm(attn, w_proj), (m + torch.log(l))[..., 0]


def block_attn_train_plain_bwd(x, mask, dout, lse, ln_scale, ln_bias, w_qkv,
                               b_qkv, w_proj, num_heads: int,
                               eps: float = 1e-6, head_dim=None,
                               partial: bool = False):
    """Recompute backward of K3 (``fused_block_attn.py:238-346``).

    Returns (dx in x.dtype, dw_qkv (3D, D), db_qkv, dw_proj (D, D), db_proj,
    dln_scale, dln_bias), the gradients f32. Rounding points: bf16 LN
    output and qkv; dy = do * mask with a bf16 copy; dattn = dy W_proj in
    f32, bf16 per head slice; p = exp(s - lse) f32, pb bf16;
    delta = sum(dattn * o) f32; ds = bf16(p (dp - delta) scale); dq, dk,
    dv f32, their bf16 copy into dW_qkv and dxn; the LN VJP per row f32;
    dx = bf16(do + dxln). With ``partial`` (a tensor-parallel rank of
    ``num_heads`` heads of ``head_dim``): dx is the f32 dxln alone, and
    dw_qkv (3 H E, D), dw_proj (D, H E) are the rank's.
    """
    dt = x.dtype
    e = head_dim or x.shape[-1] // num_heads
    scale = float(e) ** -0.5
    xhat, _, rstd = ln_stats_plain(x, eps)
    xnb = (xhat * ln_scale.float() + ln_bias.float()).to(dt)
    qkv = (_mm(xnb, w_qkv) + b_qkv).to(dt)
    q, k, v = (_heads(t, num_heads).float() for t in
               qkv.split(num_heads * e, dim=-1))

    dof = dout.float()
    dy = dof * mask.float().reshape(-1, 1, 1)
    dyb = dy.to(dt)
    da_f = _heads(torch.matmul(dyb.float(), w_proj.float()), num_heads)
    da_b = da_f.to(dt).float()

    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    pb = p.to(dt).float()
    o = torch.matmul(pb, v)
    attn = _merge_heads(o.to(dt))
    delta = (da_f * o).sum(-1, keepdim=True)
    dv = torch.matmul(pb.transpose(-1, -2), da_b)
    dp = torch.matmul(da_b, v.transpose(-1, -2))
    dsc = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(dsc, k)
    dk = torch.matmul(dsc.transpose(-1, -2), q)
    dqkv = torch.cat([_merge_heads(t) for t in (dq, dk, dv)], -1)
    dqkvb = dqkv.to(dt).float()

    sum_bn = (0, 1)
    dw_proj = torch.einsum("bno,bni->oi", dyb.float(), attn.float())
    dw_qkv = torch.einsum("bnj,bni->ji", dqkvb, xnb.float())
    dxn = torch.matmul(dqkvb, w_qkv.float())
    dxln = ln_vjp_rows(dxn, xhat, rstd, ln_scale)
    dx = dxln if partial else (dof + dxln).to(dt)
    return (dx, dw_qkv, dqkv.sum(sum_bn), dw_proj, dy.sum(sum_bn),
            (dxn * xhat).sum(sum_bn), dxn.sum(sum_bn))


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_attn(name, x, num_heads, params, head_dim=None):
    """Shape, type and device checks of the CUDA path;
    ``params``: (name, tensor, dtype, shape) of every other input;
    ``head_dim``: a tensor-parallel rank's head width (else D / heads)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, n, d = x.shape
    if head_dim is None and d % num_heads:
        raise ValueError(f"{name}: D={d} with {num_heads} heads")
    e = head_dim or d // num_heads
    if e % 2 or d % 8 or (num_heads * e) % 8 or num_heads * e > d:
        raise ValueError(
            f"{name}: D={d} with {num_heads} heads of {e} needs an even head "
            f"width, D % 8 == 0, H E % 8 == 0 and H E <= D"
        )
    _check("x", x, torch.bfloat16, (b, n, d))
    for pname, t, dtype, shape in params:
        _check(pname, t, dtype, shape)
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on x's device")


def _attn_params(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                 dh=None):
    """The inputs' expected types and shapes; ``dh``: the rank's heads'
    width H E (default D)."""
    b, _, d = x.shape
    dh = dh or d
    bf, f32 = torch.bfloat16, torch.float32
    params = [("ln_scale", ln_scale, f32, (d,)), ("ln_bias", ln_bias, f32, (d,)),
              ("w_qkv", w_qkv, bf, (3 * dh, d)),
              ("b_qkv", b_qkv, f32, (3 * dh,)), ("w_proj", w_proj, bf, (d, dh))]
    if mask is not None:
        params.append(("mask", mask, f32, (b,)))
    if b_proj is not None:
        params.append(("b_proj", b_proj, f32, (d,)))
    return params


def _check_smem(name, smem, n, e):
    if smem > _SMEM_PER_BLOCK:
        raise ValueError(f"{name}: N={n}, head width {e} needs {smem} bytes "
                         f"of shared memory per block, more than "
                         f"{_SMEM_PER_BLOCK}")


def attn_fwd_variant(dtype: torch.dtype, e: int) -> str:
    """The forward attention kernel ``csrc/attention.cuh`` launches for a
    slab of ``dtype`` and head width ``e`` (its ``launch_attention_heads``
    decides the same before launch): ``"tc"``, the tensor-core kernel, for
    bf16 with ``e % 16 == 0`` and ``16 <= e <= 128``; ``"simt"``, the
    CUDA-core kernel, otherwise."""
    if dtype == torch.bfloat16 and e % 16 == 0 and 16 <= e <= 128:
        return "tc"
    return "simt"


def _attn_fwd_smem(n: int, e: int, variant: str, itemsize: int = 2) -> int:
    """Dynamic shared memory of one forward-attention block, bytes.

    ``"tc"``: K and V of one (image, head), rows padded to a multiple of 16
    and E + 8 bf16 wide. ``"simt"``: K (rows E + 2 wide) and V in the
    slab's element size ``itemsize``, and a score row and a q row of f32
    for each of 8 warps."""
    if variant == "tc":
        return 2 * (-(-n // 16) * 16) * (e + 8) * 2
    return n * (e + 2) * itemsize + n * e * itemsize + 8 * (n + e) * 4


def attn_bwd_variant(dtype: torch.dtype, e: int) -> str:
    """The backward attention kernels ``csrc/attention_bwd.cuh`` launches
    for a slab of ``dtype`` and head width ``e`` (its
    ``launch_attention_bwd`` decides the same before launch): the forward's
    rule, ``"tc"`` (tensor cores) for bf16 with ``e % 16 == 0`` and
    ``16 <= e <= 128``, ``"simt"`` (CUDA cores) otherwise."""
    return attn_fwd_variant(dtype, e)


def _attn_bwd_smem(n: int, e: int, variant: str, itemsize: int = 2) -> int:
    """Dynamic shared memory of the larger of the backward's two launches
    (the key-tiled one), bytes; ``attn_bwd_*_smem`` in the C header.

    ``"tc"``, whatever N: K and V of the 64-key tile and two stages of a
    64-query block's Q and dO, rows E + 8 bf16 wide; the 64 x 64 P and dS
    tiles (rows 72 wide); two stages of the block's lse and delta; four
    warps' column sums of dk and dv. ``"simt"``: Q and dO of one (image,
    head) in rows E + 2 wide of ``itemsize``; lse and delta; for each of 8
    warps its k and v rows, two f32 rows of N and its column sums."""
    if variant == "tc":
        return 6 * 64 * (e + 8) * 2 + 2 * 64 * 72 * 2 + 4 * 64 * 4 + 8 * e * 4
    common = 2 * n * (e + 2) * itemsize + 8 * 2 * (e + 2) * itemsize + 8 * 2 * n * 4
    return common + 2 * n * 4 + 8 * 2 * e * 4


def _attn_bwd_variant_checked(name, dtype, n, e, ptrs):
    """The variant of a backward launch, after its shared-memory and
    alignment checks (the tensor-core kernels stage 16-byte chunks of every
    pointer in ``ptrs``)."""
    variant = attn_bwd_variant(dtype, e)
    _check_smem(name, _attn_bwd_smem(n, e, variant, dtype.itemsize), n, e)
    if variant == "tc" and any(p % 16 for p in ptrs):
        raise ValueError(f"{name}: the qkv slab and do must start 16-byte "
                         f"aligned")
    return variant


def _attn_fwd_variant_checked(name, dtype, n, e, ptr):
    """The variant of a CUDA launch, after its shared-memory and alignment
    checks (the tensor-core kernel reads 16-byte chunks of the slab)."""
    variant = attn_fwd_variant(dtype, e)
    _check_smem(name, _attn_fwd_smem(n, e, variant, dtype.itemsize), n, e)
    if variant == "tc" and ptr % 16:
        raise ValueError(f"{name}: the qkv slab must start 16-byte aligned")
    return variant


def _count_attn_launch(fn, variant: str) -> None:
    fn.launches += 1
    if variant == "tc":
        fn.tc_launches += 1
    else:
        fn.simt_launches += 1


def fused_block_attn(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int, eps: float = 1e-6):
    """Returns ``(out (B, N, D) in x.dtype, importance (B, N) f32)``; the
    importance includes the CLS key at index 0 (the caller strips it).

    x: (B, N, D) bf16; ln_scale, ln_bias, b_qkv, b_proj: f32;
    w_qkv: (3D, D), w_proj: (D, D) bf16.
    """
    if x.device.type == "cpu":
        return block_attn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                b_proj, num_heads, eps)
    _check_attn("fused_block_attn", x, num_heads,
                _attn_params(x, None, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             b_proj))
    out = torch.empty_like(x)
    imp = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    _attn_fwd_call(fused_block_attn, x, ln_scale, ln_bias, w_qkv, b_qkv,
                   w_proj, b_proj, out, imp, num_heads,
                   x.shape[-1] // num_heads, num_heads, False, eps)
    return out, imp


def _attn_fwd_call(fn, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                   out, imp, h, e, ht, partial, eps):
    """K1's entry on checked inputs (``partial``: proj's f32 sums into
    ``out``); counts the launch on the wrapper ``fn``."""
    b, n, d = x.shape
    # the attention reads the qkv workspace, fresh and so aligned
    variant = _attn_fwd_variant_checked(fn.__name__, torch.bfloat16, n, e, 0)
    bf, f32 = torch.bfloat16, torch.float32
    ws_xn = torch.empty((b * n, d), dtype=bf, device=x.device)
    ws_qkv = torch.empty((b * n, 3 * h * e), dtype=bf, device=x.device)
    ws_imp = torch.empty((b, h, n), dtype=f32, device=x.device)
    _build.call(
        "basd_block_attn_fwd",
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        0 if b_proj is None else b_proj.data_ptr(), out.data_ptr(),
        imp.data_ptr(), ws_xn.data_ptr(), ws_qkv.data_ptr(),
        ws_imp.data_ptr(), b, n, d, h, e, ht, int(partial), float(eps),
        float(e) ** -0.5, _build.stream_ptr(x.device),
    )
    _count_attn_launch(fn, variant)


def fused_block_attn_partial(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             num_heads: int, head_dim: int, heads_total: int,
                             eps: float = 1e-6):
    """K1's share on a tensor-parallel rank of ``num_heads`` (>= 1) of
    ``heads_total`` heads of ``head_dim``: one flat f32 buffer holding the
    proj sums (B*N*D, no bias, no residual) and the importance (B*N, CLS
    key included), so that one all-reduce sums both
    (``split_flat(flat, (B, N, D), (B, N))``)."""
    b, n, d = x.shape
    if x.device.type == "cpu":
        acc, imp = block_attn_plain_partial(x, ln_scale, ln_bias, w_qkv,
                                            b_qkv, w_proj, num_heads,
                                            head_dim, heads_total, eps)
        return torch.cat([acc.reshape(-1), imp.reshape(-1)])
    _check_attn("fused_block_attn_partial", x, num_heads,
                _attn_params(x, None, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             None, num_heads * head_dim), head_dim)
    flat = torch.empty((b * n * (d + 1),), dtype=torch.float32,
                       device=x.device)
    out, imp = split_flat(flat, (b, n, d), (b, n))
    _attn_fwd_call(fused_block_attn_partial, x, ln_scale, ln_bias, w_qkv,
                   b_qkv, w_proj, None, out, imp, num_heads, head_dim,
                   heads_total, True, eps)
    return flat


def split_flat(flat, *shapes):
    """Views of consecutive pieces of ``flat`` with the given shapes."""
    views, i = [], 0
    for shape in shapes:
        size = 1
        for s in shape:
            size *= s
        views.append(flat[i:i + size].view(shape))
        i += size
    return views


def fused_block_attn_train_fwd(x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                               w_proj, b_proj, num_heads: int,
                               eps: float = 1e-6):
    """K3a: ``(out (B, N, D) bf16, lse (B, H, N) f32)``.

    x: (B, N, D) bf16; mask: (B,) f32 stochastic-depth multipliers;
    ln_scale, ln_bias, b_qkv, b_proj: f32; w_qkv: (3D, D), w_proj: (D, D)
    bf16.
    """
    if x.device.type == "cpu":
        return block_attn_train_plain_fwd(x, mask, ln_scale, ln_bias, w_qkv,
                                          b_qkv, w_proj, b_proj, num_heads,
                                          eps)
    _check_attn("fused_block_attn_train_fwd", x, num_heads,
                _attn_params(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             b_proj))
    return _attn_train_fwd_call(fused_block_attn_train_fwd, x, mask, ln_scale,
                                ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                                torch.empty_like(x), num_heads,
                                x.shape[-1] // num_heads, False, eps)


def _attn_train_fwd_call(fn, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                         b_proj, out, h, e, partial, eps):
    """K3a's entry on checked inputs (``partial``: proj's f32 sums into
    ``out``, mask and b_proj unused); counts the launch on ``fn``."""
    b, n, d = x.shape
    variant = _attn_fwd_variant_checked(fn.__name__, torch.bfloat16, n, e, 0)
    bf = torch.bfloat16
    lse = torch.empty((b, h, n), dtype=torch.float32, device=x.device)
    ws_xn = torch.empty((b * n, d), dtype=bf, device=x.device)
    ws_qkv = torch.empty((b * n, 3 * h * e), dtype=bf, device=x.device)
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    _build.call(
        "basd_block_attn_train_fwd",
        x.data_ptr(), ptr(mask), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(), ptr(b_proj),
        out.data_ptr(), lse.data_ptr(), ws_xn.data_ptr(), ws_qkv.data_ptr(),
        b, n, d, h, e, int(partial), float(eps), float(e) ** -0.5,
        _build.stream_ptr(x.device),
    )
    _count_attn_launch(fn, variant)
    return out, lse


def fused_block_attn_train_fwd_partial(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_proj, num_heads: int, head_dim: int,
                                       eps: float = 1e-6):
    """K3a's share on a tensor-parallel rank of ``num_heads`` (>= 1) heads
    of ``head_dim``: ``(proj sums (B, N, D) f32, lse (B, H, N) f32)``, no
    bias, mask or residual."""
    if x.device.type == "cpu":
        return block_attn_train_plain_fwd_partial(
            x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, num_heads, head_dim,
            eps)
    _check_attn("fused_block_attn_train_fwd_partial", x, num_heads,
                _attn_params(x, None, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             None, num_heads * head_dim), head_dim)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return _attn_train_fwd_call(fused_block_attn_train_fwd_partial, x, None,
                                ln_scale, ln_bias, w_qkv, b_qkv, w_proj, None,
                                out, num_heads, head_dim, True, eps)


def fused_block_attn_train_bwd(x, mask, dout, lse, ln_scale, ln_bias, w_qkv,
                               b_qkv, w_proj, num_heads: int,
                               eps: float = 1e-6):
    """K3b: ``(dx bf16, dw_qkv, db_qkv, dw_proj, db_proj, dln_scale,
    dln_bias)``, the gradients f32 and summed over the batch. On CUDA its
    attention takes the tensor-core backward for E % 16 == 0 in [16, 128]
    and the CUDA-core one for any other even E (``attn_bwd_variant``)."""
    if x.device.type == "cpu":
        return block_attn_train_plain_bwd(x, mask, dout, lse, ln_scale,
                                          ln_bias, w_qkv, b_qkv, w_proj,
                                          num_heads, eps)
    b, n, d = x.shape
    h = num_heads
    f32, bf = torch.float32, torch.bfloat16
    _check_attn("fused_block_attn_train_bwd", x, h,
                _attn_params(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             None)
                + [("dout", dout, bf, (b, n, d)), ("lse", lse, f32, (b, h, n))])
    dx = torch.empty_like(x)
    db_proj, dln_s, dln_b = (torch.empty((d,), dtype=f32, device=x.device)
                             for _ in range(3))
    return (dx,) + _attn_train_bwd_call(
        fused_block_attn_train_bwd, x, mask, dout, lse, ln_scale, ln_bias,
        w_qkv, b_qkv, w_proj, dx, db_proj, dln_s, dln_b, h, d // h, False, eps)


def _attn_train_bwd_call(fn, x, mask, dout, lse, ln_scale, ln_bias, w_qkv,
                         b_qkv, w_proj, dx, db_proj, dln_s, dln_b, h, e,
                         partial, eps):
    """K3b's entry on checked inputs (``partial``: the f32 dxln into
    ``dx``; db_proj may be None); counts the launch and its products on
    ``fn``. Returns (dw_qkv, db_qkv, dw_proj, db_proj, dln_s, dln_b)."""
    b, n, d = x.shape
    dh = h * e
    f32, bf = torch.float32, torch.bfloat16
    # the attention reads the qkv and dattn workspaces, fresh and so aligned
    variant = _attn_bwd_variant_checked(fn.__name__, bf, n, e, ())
    m = b * n
    dev = x.device
    chunks = -(-m // _ROW_CHUNK)
    dw_qkv = torch.empty((3 * dh, d), dtype=f32, device=dev)
    db_qkv = torch.empty((3 * dh,), dtype=f32, device=dev)
    dw_proj = torch.empty((d, dh), dtype=f32, device=dev)
    ws_xn, ws_dyb = (torch.empty((m, d), dtype=bf, device=dev)
                     for _ in range(2))
    ws_attn = torch.empty((m, dh), dtype=bf, device=dev)
    ws_qkv, ws_dqkv = (torch.empty((m, 3 * dh), dtype=bf, device=dev)
                       for _ in range(2))
    ws_stats = torch.empty((2 * m,), dtype=f32, device=dev)
    ws_f32 = torch.empty((m, d), dtype=f32, device=dev)
    # the weight gradients' split-K partials; the attention's column sums:
    # one row per (image, 64-query tile)
    tiles = -(-n // 64)
    ws_part = torch.empty((max(weight_grad_floats(m, ((d, dh), (3 * dh, d))),
                               b * tiles * 3 * dh, 2 * chunks * d),),
                          dtype=f32, device=dev)
    ws_delta = torch.empty((b, h, n), dtype=f32, device=dev)
    _build.call(
        "basd_block_attn_train_bwd",
        x.data_ptr(), mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), w_proj.data_ptr(), dx.data_ptr(), dw_qkv.data_ptr(),
        db_qkv.data_ptr(), dw_proj.data_ptr(),
        0 if db_proj is None else db_proj.data_ptr(),
        dln_s.data_ptr(), dln_b.data_ptr(), ws_xn.data_ptr(),
        ws_stats.data_ptr(), ws_qkv.data_ptr(), ws_dyb.data_ptr(),
        ws_f32.data_ptr(), ws_attn.data_ptr(), ws_dqkv.data_ptr(),
        ws_part.data_ptr(), ws_delta.data_ptr(), b, n, d, h, e, _ROW_CHUNK,
        int(partial), float(eps), float(e) ** -0.5, _build.stream_ptr(dev),
    )
    _count_attn_launch(fn, variant)
    # dattn = dy W_proj, dW_proj = dy^T attn, dW_qkv = dqkv^T xn, dxn =
    # dqkv W_qkv (csrc/block_train.cu)
    count_products(fn, bf, (
        ((d, dh), (ws_dyb, w_proj, ws_f32)),
        ((d, dh), (ws_dyb, ws_attn, ws_part)),
        ((3 * dh, d), (ws_dqkv, ws_xn, ws_part)),
        ((3 * dh, d), (ws_dqkv, w_qkv, ws_f32))))
    return dw_qkv, db_qkv, dw_proj, db_proj, dln_s, dln_b


def fused_block_attn_train_bwd_partial(x, mask, dout, lse, ln_scale, ln_bias,
                                       w_qkv, b_qkv, w_proj, num_heads: int,
                                       head_dim: int, eps: float = 1e-6):
    """K3b's share on a tensor-parallel rank of ``num_heads`` (>= 1) heads
    of ``head_dim``: ``(flat, dw_qkv, db_qkv, dw_proj)``, ``flat`` one f32
    buffer of the rank's dxln (B*N*D, without do) and its LN-parameter sums
    (D, D), so that one all-reduce sums them (``split_flat(flat, (B, N, D),
    (D,), (D,))``). The gradients f32; db_proj is the caller's."""
    b, n, d = x.shape
    h = num_heads
    if x.device.type == "cpu":
        dx, dwq, dbq, dwp, _, dls, dlb = block_attn_train_plain_bwd(
            x, mask, dout, lse, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, h,
            eps, head_dim, partial=True)
        return torch.cat([dx.reshape(-1), dls, dlb]), dwq, dbq, dwp
    f32, bf = torch.float32, torch.bfloat16
    _check_attn("fused_block_attn_train_bwd_partial", x, h,
                _attn_params(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                             None, h * head_dim)
                + [("dout", dout, bf, (b, n, d)), ("lse", lse, f32, (b, h, n))],
                head_dim)
    flat = torch.empty((b * n * d + 2 * d,), dtype=f32, device=x.device)
    dx, dln_s, dln_b = split_flat(flat, (b, n, d), (d,), (d,))
    dwq, dbq, dwp, *_ = _attn_train_bwd_call(
        fused_block_attn_train_bwd_partial, x, mask, dout, lse, ln_scale,
        ln_bias, w_qkv, b_qkv, w_proj, dx, None, dln_s, dln_b, h, head_dim,
        True, eps)
    return flat, dwq, dbq, dwp


for _fn in (fused_block_attn, fused_block_attn_train_fwd,
            fused_block_attn_train_bwd, fused_block_attn_partial,
            fused_block_attn_train_fwd_partial,
            fused_block_attn_train_bwd_partial):
    _fn.launches = _fn.tc_launches = _fn.simt_launches = 0
# backward products by GEMM variant (gemm.gemm_bwd_variant), four a launch
fused_block_attn_train_bwd.gemm_variants = {"sm90": 0, "wmma": 0, "f32": 0}
fused_block_attn_train_bwd_partial.gemm_variants = {"sm90": 0, "wmma": 0,
                                                    "f32": 0}


class FusedBlockAttnTrain(torch.autograd.Function):
    """K3a forward, K3b backward; the mask is not differentiated."""

    @staticmethod
    def forward(ctx, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, eps):
        out, lse = fused_block_attn_train_fwd(x, mask, ln_scale, ln_bias,
                                              w_qkv, b_qkv, w_proj, b_proj,
                                              num_heads, eps)
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                              w_proj, b_proj, lse)
        ctx.num_heads, ctx.eps = num_heads, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mask, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj, lse = ctx.saved_tensors
        dx, dwq, dbq, dwp, dbp, dls, dlb = fused_block_attn_train_bwd(
            x, mask, dout.to(x.dtype).contiguous(), lse, ln_s, ln_b, w_qkv,
            b_qkv, w_proj, ctx.num_heads, ctx.eps)
        return (dx, None, dls.to(ln_s.dtype), dlb.to(ln_b.dtype),
                dwq.to(w_qkv.dtype), dbq.to(b_qkv.dtype), dwp.to(w_proj.dtype),
                dbp.to(b_proj.dtype), None, None)


def fused_block_attn_train(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                           b_proj, num_heads: int, eps: float = 1e-6):
    """``x + mask * proj(MHSA(qkv(LN(x))))``, differentiable (K3a/K3b)."""
    return FusedBlockAttnTrain.apply(x.contiguous(), mask, ln_scale, ln_bias,
                                     w_qkv, b_qkv, w_proj, b_proj, num_heads,
                                     eps)


def fused_block_attn_tp(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                        num_heads: int, head_dim: int, heads_total: int,
                        eps: float, reduce_):
    """The teacher's attention half on a tensor-parallel rank (forward
    only): K1's share (none for a rank without heads), summed over the
    model group in place by ``reduce_``, then ``residual_add``. Returns
    ``(out, importance (B, N))`` as ``fused_block_attn``."""
    b, n, d = x.shape
    if num_heads:
        flat = fused_block_attn_partial(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                        w_proj, num_heads, head_dim,
                                        heads_total, eps)
    else:
        flat = torch.zeros((b * n * (d + 1),), dtype=torch.float32,
                           device=x.device)
    reduce_(flat)
    acc, imp = split_flat(flat, (b, n, d), (b, n))
    return residual_add(x, None, acc, b_proj), imp


class FusedBlockAttnTrainTP(torch.autograd.Function):
    """The student's attention half on a tensor-parallel rank: K3a's share
    summed over the model group (``reduce_``, in place), then
    ``residual_add``; backward: K3b's share (dxln and the LN-parameter
    sums in one buffer) summed the same way, dx = x's dtype of do + the
    sum, db_proj the sum of do * mask (the same bits on every rank). The
    rank's qkv and proj gradients are its own. A rank without heads
    launches nothing and contributes zeros."""

    @staticmethod
    def forward(ctx, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, head_dim, eps, reduce_):
        b, n, d = x.shape
        if num_heads:
            acc, lse = fused_block_attn_train_fwd_partial(
                x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, num_heads,
                head_dim, eps)
        else:
            acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            lse = torch.empty((b, 0, n), dtype=torch.float32, device=x.device)
        reduce_(acc)
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                              w_proj, lse)
        ctx.num_heads, ctx.head_dim, ctx.eps = num_heads, head_dim, eps
        ctx.reduce_ = reduce_
        return residual_add(x, mask, acc, b_proj)

    @staticmethod
    def backward(ctx, dout):
        x, mask, ln_s, ln_b, w_qkv, b_qkv, w_proj, lse = ctx.saved_tensors
        b, n, d = x.shape
        dout = dout.to(x.dtype).contiguous()
        if ctx.num_heads:
            flat, dwq, dbq, dwp = fused_block_attn_train_bwd_partial(
                x, mask, dout, lse, ln_s, ln_b, w_qkv, b_qkv, w_proj,
                ctx.num_heads, ctx.head_dim, ctx.eps)
        else:
            flat = torch.zeros((b * n * d + 2 * d,), dtype=torch.float32,
                               device=x.device)
            dwq, dbq, dwp = (torch.zeros(t.shape, dtype=torch.float32,
                                         device=x.device)
                             for t in (w_qkv, b_qkv, w_proj))
        ctx.reduce_(flat)
        dxln, dls, dlb = split_flat(flat, (b, n, d), (d,), (d,))
        dy = dout.float() * mask.float().reshape(-1, 1, 1)
        dx = (dout.float() + dxln).to(x.dtype)
        return (dx, None, dls.to(ln_s.dtype), dlb.to(ln_b.dtype),
                dwq.to(w_qkv.dtype), dbq.to(b_qkv.dtype), dwp.to(w_proj.dtype),
                dy.sum((0, 1)), None, None, None, None)


def fused_block_attn_train_tp(x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                              w_proj, b_proj, num_heads: int, head_dim: int,
                              eps: float, reduce_):
    """``x + mask * proj(MHSA(qkv(LN(x))))`` on a tensor-parallel rank,
    differentiable (``FusedBlockAttnTrainTP``)."""
    return FusedBlockAttnTrainTP.apply(x.contiguous(), mask, ln_scale,
                                       ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                                       num_heads, head_dim, eps, reduce_)
