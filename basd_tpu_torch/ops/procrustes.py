"""Attention-weighted Procrustes loss (counterpart of
``basd_tpu/ops/procrustes.py``).

``geometric_relational_loss`` is the composed form, the reference's own
shape: ``mean_B(tr(S^T S) + tr(T^T T) - 2 ||S_w^T T_w||_*)`` over
weighted-centred, ``sqrt(w)``-scaled panels. ``geometric_relational_loss_ident``
rewrites it through the weighted-centring identities so the (larger)
teacher panel is consumed raw; on its fast path the nuclear norm is
``tr(P^T C)`` with P the Newton-Schulz polar factor of the cross-covariance
C (K7 at the reference's shapes) and ``_IdentCore`` carries the reference's
closed-form backward. ``nuclear_backend`` 'svd' takes ``torch.linalg.svdvals``
(the parity path), 'eigh' the Gram eigenvalues with the polar backward.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.ops import linalg
from basd_tpu_torch.ops.interp import linear_interp1d
from basd_tpu_torch.parallel.mesh import DataParallel


def _slice_mean_shift(teacher_tokens: torch.Tensor,
                      dp: DataParallel | None = None) -> torch.Tensor:
    """Constant channel shift (batch-slice + token mean), no gradient: the
    mean over the first 64 images of the (global) batch. With ``dp``,
    ``teacher_tokens`` holds this rank's equal shard; each rank adds its
    part of those images, weighted by its share of them."""
    dp = dp or DataParallel()
    b = teacher_tokens.shape[-3]
    rows = dp.rows(b * dp.world)
    b_slice = min(b * dp.world, 64)
    k = max(0, min(rows.stop, b_slice) - rows.start)
    if k == 0:
        return dp.sum(torch.zeros_like(teacher_tokens[..., :1, :1, :],
                                       dtype=torch.float32))
    part = teacher_tokens[..., :k, :, :].detach().float().mean(
        dim=(-3, -2), keepdim=True)
    return dp.sum(part * (k / b_slice))


class _IdentCore(torch.autograd.Function):
    """Identity-form Procrustes loss core with the hand-written backward
    (``procrustes.py:199-294``). Inputs: s (..., N, D_s), t (..., N, D_t),
    w (..., N) normalised f32 weights. Output (...,)."""

    @staticmethod
    def forward(ctx, s_in, t_in, w, c):
        s = s_in.float()
        mu_s = torch.einsum("...n,...nd->...d", w, s)
        s_c = s - mu_s[..., None, :]
        sw2 = w[..., None] * s_c
        tr_s = (sw2 * s_c).sum(dim=(-1, -2))

        t_c = t_in.float() - c
        rowsq = (t_c * t_c).sum(-1)
        mu_tc = torch.einsum("...n,...nd->...d", w, t_c)
        tr_t = (w * rowsq).sum(-1) - (mu_tc * mu_tc).sum(-1)

        cross = torch.matmul(sw2.transpose(-1, -2), t_c)  # (..., D_s, D_t)
        p = linalg.newton_schulz_polar(cross, schedule="hybrid")
        nuclear = (p.float() * cross.float()).sum(dim=(-2, -1))
        ctx.save_for_backward(s_in, t_in, w, c, mu_s, mu_tc, p)
        return tr_s + tr_t - 2.0 * nuclear

    @staticmethod
    def backward(ctx, g):
        s_in, t_in, w, c, mu_s, mu_tc, p = ctx.saved_tensors
        s = s_in.float()
        s_c = s - mu_s[..., None, :]
        t_c = t_in.float() - c
        p = p.float()

        tp = torch.matmul(t_c, p.transpose(-1, -2))  # (..., N, D_s)
        sp = torch.matmul(s_c, p)  # (..., N, D_t)

        g2w = (2.0 * g[..., None]) * w
        ds_pre = g2w[..., None] * (s_c - tp)
        colsum = ds_pre.sum(-2)
        ds = ds_pre - w[..., None] * colsum[..., None, :]
        dt = g2w[..., None] * (t_c - mu_tc[..., None, :] - sp)

        pmu = torch.einsum("...st,...t->...s", p, mu_tc)
        dw = g[..., None] * (
            (s_c * (s_c - 2.0 * tp + 2.0 * pmu[..., None, :])).sum(-1)
            + (t_c * (t_c - 2.0 * mu_tc[..., None, :])).sum(-1)
            + 2.0 * (mu_s * pmu).sum(-1)[..., None]
        )
        return ds.to(s_in.dtype), dt.to(t_in.dtype), dw.to(w.dtype), None


def _nuclear(cross: torch.Tensor, nuclear_backend: str) -> torch.Tensor:
    if nuclear_backend == "svd":
        return linalg.nuclear_norm_ref(cross)
    if nuclear_backend == "eigh":
        return linalg.nuclear_norm(cross)
    return linalg.nuclear_norm_ns(cross)


def _normalised_weights(importance: torch.Tensor, n: int) -> torch.Tensor:
    w = importance.float()
    if w.shape[-1] != n:
        w = linear_interp1d(w, n, axis=-1)
    return w / w.sum(-1, keepdim=True)


def geometric_relational_loss(student_tokens, teacher_tokens, importance, *,
                              nuclear_backend: str = "gram"):
    """Composed-form Procrustes loss (``procrustes.py:44-101``).

    Args:
        student_tokens: (B, N_s, D_s).
        teacher_tokens: (B, N_s, D_t), token count already aligned.
        importance: (B, N_w) reduced attention importance, resampled to N_s.

    Returns the scalar loss (mean over the batch). ``nuclear_backend``:
    'svd' (parity), 'eigh' (Gram eigenvalues), otherwise the Newton-Schulz
    trace form.
    """
    s = student_tokens.float()
    t = teacher_tokens.float()
    w = _normalised_weights(importance, s.shape[1])
    mu_s = torch.einsum("bn,bnd->bd", w, s)[:, None, :]
    mu_t = torch.einsum("bn,bnd->bd", w, t)[:, None, :]
    w_sqrt = torch.sqrt(w)[..., None]
    s_w = w_sqrt * (s - mu_s)
    t_w = w_sqrt * (t - mu_t)
    tr_s = (s_w * s_w).sum(dim=(1, 2))
    tr_t = (t_w * t_w).sum(dim=(1, 2))
    cross = torch.matmul(s_w.transpose(-1, -2), t_w)  # (B, D_s, D_t)
    return (tr_s + tr_t - 2.0 * _nuclear(cross, nuclear_backend)).mean()


def geometric_relational_loss_ident(student_tokens, teacher_tokens,
                                    importance, *,
                                    nuclear_backend: str = "gram",
                                    dp: DataParallel | None = None):
    """Identity-form Procrustes loss, batched over leading dims.

    Args:
        student_tokens: (..., B, N, D_s).
        teacher_tokens: (..., B, N, D_t), token count already aligned.
        importance: (..., B, N_w) unnormalised weights, resampled to N.
        dp: the data-parallel group whose shard B is (the teacher's
            constant shift is the global batch's).

    Returns the (..., B)-shaped per-sample loss.
    """
    w = _normalised_weights(importance, student_tokens.shape[-2])
    shift = _slice_mean_shift(teacher_tokens, dp)
    if nuclear_backend not in ("svd", "eigh"):
        return _IdentCore.apply(student_tokens, teacher_tokens, w, shift)

    # 'svd' / 'eigh': the same identities by plain autograd; the teacher
    # side shifted by the stop-gradient slice mean (cross and tr_t are
    # invariant to any constant channel shift of t)
    s = student_tokens.float()
    mu_s = torch.einsum("...n,...nd->...d", w, s)
    s_c = s - mu_s[..., None, :]
    sw2 = w[..., None] * s_c
    tr_s = (sw2 * s_c).sum(dim=(-1, -2))
    t_c = teacher_tokens.float() - shift
    rowsq = (t_c * t_c).sum(-1)
    mu_tc = torch.einsum("...n,...nd->...d", w, t_c)
    tr_t = (w * rowsq).sum(-1) - (mu_tc * mu_tc).sum(-1)
    cross = torch.matmul(sw2.transpose(-1, -2), t_c)
    return tr_s + tr_t - 2.0 * _nuclear(cross, nuclear_backend)
