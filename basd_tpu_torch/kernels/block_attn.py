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

The attention of K1 and K3a is the forward attention core of
``csrc/attention.cuh``, which K10a and K10c share: ``attn_fwd_variant``
says which of its two kernels a slab takes (the tensor-core kernel for bf16
with a head width E % 16 == 0, 16 <= E <= 128; the CUDA-core kernel for
any other even E and for f32), ``_attn_fwd_smem`` the shared memory it
needs. K3b's attention is the backward core of ``csrc/attention_bwd.cuh``,
which K10b shares, with the same rule (``attn_bwd_variant``) and two
launches of either variant (``_attn_bwd_smem``). Each of the six wrappers
counts its launches of each variant in ``tc_launches`` and
``simt_launches`` beside ``launches``.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.layernorm import (
    layernorm_plain_fwd,
    ln_stats_plain,
    ln_vjp_rows,
)

_SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared-memory limit
_ROW_CHUNK = 256  # rows per partial of the backward's column sums
_TARGET_BLOCKS = 528  # split-K target: four blocks per SM of an H100


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


def _attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, num_heads, eps):
    """LN, qkv and per-head softmax attention with deferred normalisation:
    returns (attn (B, N, D) in x.dtype, unnormalised p, row max m, row
    sum l), the last three f32 (B, H, N, N | 1)."""
    d = x.shape[-1]
    scale = float(d // num_heads) ** -0.5
    xnb = layernorm_plain_fwd(x, ln_scale, ln_bias, eps)[0]
    qkv = (_mm(xnb, w_qkv) + b_qkv).to(x.dtype)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(d, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(x.dtype).float(), v.float()) / l
    return _merge_heads(o.to(x.dtype)), p, m, l


def block_attn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int, eps: float = 1e-6):
    attn, p, _, l = _attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                     num_heads, eps)
    row0 = p[:, :, 0, :] / (l[:, :, 0] * num_heads)  # (B, H, N)
    imp = row0[:, 0]
    for i in range(1, num_heads):
        imp = imp + row0[:, i]
    y = (_mm(attn, w_proj) + b_proj).to(x.dtype).float()
    return (x.float() + y).to(x.dtype), imp


def block_attn_train_plain_fwd(x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                               w_proj, b_proj, num_heads: int,
                               eps: float = 1e-6):
    """Returns (out (B, N, D) in x.dtype, lse (B, H, N) f32)."""
    attn, _, m, l = _attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                     num_heads, eps)
    y = (_mm(attn, w_proj) + b_proj).to(x.dtype).float()
    out = (x.float() + y * mask.float().reshape(-1, 1, 1)).to(x.dtype)
    return out, (m + torch.log(l))[..., 0]


def block_attn_train_plain_bwd(x, mask, dout, lse, ln_scale, ln_bias, w_qkv,
                               b_qkv, w_proj, num_heads: int,
                               eps: float = 1e-6):
    """Recompute backward of K3 (``fused_block_attn.py:238-346``).

    Returns (dx in x.dtype, dw_qkv (3D, D), db_qkv, dw_proj (D, D), db_proj,
    dln_scale, dln_bias), the gradients f32. Rounding points: bf16 LN
    output and qkv; dy = do * mask with a bf16 copy; dattn = dy W_proj in
    f32, bf16 per head slice; p = exp(s - lse) f32, pb bf16;
    delta = sum(dattn * o) f32; ds = bf16(p (dp - delta) scale); dq, dk,
    dv f32, their bf16 copy into dW_qkv and dxn; the LN VJP per row f32;
    dx = bf16(do + dxln).
    """
    dt = x.dtype
    d = x.shape[-1]
    scale = float(d // num_heads) ** -0.5
    xhat, _, rstd = ln_stats_plain(x, eps)
    xnb = (xhat * ln_scale.float() + ln_bias.float()).to(dt)
    qkv = (_mm(xnb, w_qkv) + b_qkv).to(dt)
    q, k, v = (_heads(t, num_heads).float() for t in qkv.split(d, dim=-1))

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
    dx = (dof + dxln).to(dt)
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


def _check_attn(name, x, num_heads, params):
    """Shape, type and device checks of the CUDA path;
    ``params``: (name, tensor, dtype, shape) of every other input."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, n, d = x.shape
    if d % num_heads or (d // num_heads) % 2 or d % 8:
        raise ValueError(
            f"{name}: D={d} with {num_heads} heads needs an even head width "
            f"and D % 8 == 0"
        )
    _check("x", x, torch.bfloat16, (b, n, d))
    for pname, t, dtype, shape in params:
        _check(pname, t, dtype, shape)
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on x's device")


def _attn_params(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj):
    b, _, d = x.shape
    bf, f32 = torch.bfloat16, torch.float32
    params = [("ln_scale", ln_scale, f32, (d,)), ("ln_bias", ln_bias, f32, (d,)),
              ("w_qkv", w_qkv, bf, (3 * d, d)), ("b_qkv", b_qkv, f32, (3 * d,)),
              ("w_proj", w_proj, bf, (d, d))]
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
    b, n, d = x.shape
    e = d // num_heads
    # the attention reads the qkv workspace, fresh and so aligned
    variant = _attn_fwd_variant_checked("fused_block_attn", torch.bfloat16,
                                        n, e, 0)
    bf, f32 = torch.bfloat16, torch.float32
    out = torch.empty_like(x)
    imp = torch.empty((b, n), dtype=f32, device=x.device)
    ws_xn = torch.empty((b * n, d), dtype=bf, device=x.device)
    ws_qkv = torch.empty((b * n, 3 * d), dtype=bf, device=x.device)
    ws_imp = torch.empty((b, num_heads, n), dtype=f32, device=x.device)
    _build.call(
        "basd_block_attn_fwd",
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), out.data_ptr(), imp.data_ptr(), ws_xn.data_ptr(),
        ws_qkv.data_ptr(), ws_imp.data_ptr(), b, n, d, num_heads,
        float(eps), float(e) ** -0.5, _build.stream_ptr(x.device),
    )
    _count_attn_launch(fused_block_attn, variant)
    return out, imp


def split_k_chunk(rows: int, tiles: int) -> int:
    """Contraction rows per split-K slice of a weight-gradient GEMM with
    ``tiles`` 64x64 output tiles: enough slices for about four blocks per
    SM, each a multiple of the 32-row K step."""
    splits = max(1, min(-(-rows // 32), -(-_TARGET_BLOCKS // tiles)))
    per_split = -(-rows // splits)
    return -(-per_split // 32) * 32


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
    b, n, d = x.shape
    e = d // num_heads
    variant = _attn_fwd_variant_checked("fused_block_attn_train_fwd",
                                        torch.bfloat16, n, e, 0)
    bf = torch.bfloat16
    out = torch.empty_like(x)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=x.device)
    ws_xn = torch.empty((b * n, d), dtype=bf, device=x.device)
    ws_qkv = torch.empty((b * n, 3 * d), dtype=bf, device=x.device)
    _build.call(
        "basd_block_attn_train_fwd",
        x.data_ptr(), mask.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), out.data_ptr(), lse.data_ptr(), ws_xn.data_ptr(),
        ws_qkv.data_ptr(), b, n, d, num_heads, float(eps), float(e) ** -0.5,
        _build.stream_ptr(x.device),
    )
    _count_attn_launch(fused_block_attn_train_fwd, variant)
    return out, lse


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
    e = d // h
    # the attention reads the qkv and dattn workspaces, fresh and so aligned
    variant = _attn_bwd_variant_checked("fused_block_attn_train_bwd", bf, n,
                                        e, ())
    m = b * n
    dev = x.device
    k_chunk = split_k_chunk(m, -(-3 * d // 64) * -(-d // 64))
    splits = -(-m // k_chunk)
    chunks = -(-m // _ROW_CHUNK)
    dx = torch.empty_like(x)
    dw_qkv = torch.empty((3 * d, d), dtype=f32, device=dev)
    db_qkv = torch.empty((3 * d,), dtype=f32, device=dev)
    dw_proj = torch.empty((d, d), dtype=f32, device=dev)
    db_proj, dln_s, dln_b = (torch.empty((d,), dtype=f32, device=dev)
                             for _ in range(3))
    ws_xn, ws_dyb, ws_attn = (torch.empty((m, d), dtype=bf, device=dev)
                              for _ in range(3))
    ws_qkv, ws_dqkv = (torch.empty((m, 3 * d), dtype=bf, device=dev)
                       for _ in range(2))
    ws_stats = torch.empty((2 * m,), dtype=f32, device=dev)
    ws_f32 = torch.empty((m, d), dtype=f32, device=dev)
    # the attention's column sums: one row per (image, 64-query tile)
    tiles = -(-n // 64)
    ws_part = torch.empty((max(splits * 3 * d * d, b * tiles * 3 * d,
                               2 * chunks * d),), dtype=f32, device=dev)
    ws_delta = torch.empty((b, h, n), dtype=f32, device=dev)
    _build.call(
        "basd_block_attn_train_bwd",
        x.data_ptr(), mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), w_proj.data_ptr(), dx.data_ptr(), dw_qkv.data_ptr(),
        db_qkv.data_ptr(), dw_proj.data_ptr(), db_proj.data_ptr(),
        dln_s.data_ptr(), dln_b.data_ptr(), ws_xn.data_ptr(),
        ws_stats.data_ptr(), ws_qkv.data_ptr(), ws_dyb.data_ptr(),
        ws_f32.data_ptr(), ws_attn.data_ptr(), ws_dqkv.data_ptr(),
        ws_part.data_ptr(), ws_delta.data_ptr(), b, n, d, h, k_chunk,
        _ROW_CHUNK, float(eps), float(e) ** -0.5, _build.stream_ptr(dev),
    )
    _count_attn_launch(fused_block_attn_train_bwd, variant)
    return dx, dw_qkv, db_qkv, dw_proj, db_proj, dln_s, dln_b


fused_block_attn.launches = 0
fused_block_attn_train_fwd.launches = 0
fused_block_attn_train_bwd.launches = 0
for _fn in (fused_block_attn, fused_block_attn_train_fwd,
            fused_block_attn_train_bwd):
    _fn.tc_launches = _fn.simt_launches = 0


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
