"""The BASD loss in plain PyTorch: label-smoothed cross-entropy on the
mixed targets; the spectral layer selector (centred Grams of the projected
teacher layers and student points, one stacked symmetric eigh,
Marchenko-Pastur ranks of the teacher spectra through a rank-one secular
update, spectrally weighted principal angles between the masked bases,
softmax(-d^2 / tau) mixing weights over the teacher layers); the mixed
teacher tokens and importance; the attention-weighted Procrustes loss in
its identity form, whose nuclear norm is tr(P^T C) with P the hybrid
Newton-Schulz polar factor of the cross-covariance C (5 quintic and 2 cubic
steps, the configuration's own schedule); and UW-SO's inverse-loss weights.
The eigh backward clamps the gaps between eigenvalues at 1e-6, as the BASD
package defines it for degenerate spectra. Under the 'jacobi' spectral
backend the principal angles' eigenvalues are the configuration's own
algorithm: 6 sweeps of cyclic parallel (Brent-Luk) Jacobi rotations,
which leave them short of converged."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.arith import Arith

_EPS = float(torch.finfo(torch.float32).eps)
_EIG_FLOOR = 1e-30
_GAP_CLAMP = 1e-6
QUINTIC = ((4.0848, -6.8946, 2.9270), (3.9505, -6.3029, 2.6377),
           (3.7418, -5.5913, 2.3037), (2.8769, -3.1427, 1.2046),
           (2.8366, -3.0525, 1.2012))
CUBIC_STEPS = 2


class _Eigh(torch.autograd.Function):
    """Ascending symmetric eigh with the gap-clamped backward."""

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh((a + a.transpose(-1, -2)) / 2.0)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, dw, dv):
        w, v = ctx.saved_tensors
        diffs = w[..., None, :] - w[..., :, None]
        denom = torch.where(diffs >= 0, 1.0, -1.0) * diffs.abs().clamp(
            min=_GAP_CLAMP)
        eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
        inner = (1.0 / denom) * (1.0 - eye) * (v.transpose(-1, -2) @ dv)
        inner = inner + eye * dw[..., None, :]
        da = v @ inner @ v.transpose(-1, -2)
        return (da + da.transpose(-1, -2)) / 2.0


JACOBI_SWEEPS = 6


def _jacobi_pairs(n: int) -> np.ndarray:
    """(n - 1, n/2, 2): each round's disjoint index pairs (p, q), slot j
    paired with slot j + n/2, the slots then permuted so that every pair
    meets once a sweep (Brent-Luk's ordering)."""
    m = n // 2
    sigma = np.empty(n, np.int64)
    sigma[0], sigma[1], sigma[n - 1] = 0, m, m - 1
    sigma[2:m] = np.arange(1, m - 1)
    sigma[m:n - 1] = np.arange(m + 1, n)
    slots = np.arange(n)
    table = np.empty((n - 1, m, 2), np.int64)
    for r in range(n - 1):
        table[r, :, 0], table[r, :, 1] = slots[:m], slots[m:]
        slots = slots[sigma]
    return table


def jacobi_eigh(a: torch.Tensor, sweeps: int = JACOBI_SWEEPS):
    """(ascending w, V) of symmetric (B, n, n) f32, n even, after
    ``sweeps`` sweeps of n - 1 rounds of n/2 Givens rotations; a pair with
    |a_pq| <= 1e-30 is not rotated."""
    bsz, n, _ = a.shape
    a = a.float().clone()
    v = torch.eye(n, device=a.device).expand(bsz, n, n).clone()
    table = torch.as_tensor(_jacobi_pairs(n), device=a.device)
    for it in range(sweeps * (n - 1)):
        p, q = table[it % (n - 1)].unbind(-1)
        app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
        ok = apq.abs() > 1e-30
        tau = (aqq - app) / (2.0 * torch.where(ok, apq, torch.ones_like(apq)))
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(ok, t, torch.zeros_like(t))
        c = torch.rsqrt(1.0 + t * t)
        s = t * c
        for x in (a, v):  # columns: x <- x J
            xp, xq = x[:, :, p], x[:, :, q]
            x[:, :, p] = c[:, None, :] * xp - s[:, None, :] * xq
            x[:, :, q] = s[:, None, :] * xp + c[:, None, :] * xq
        ap, aq = a[:, p, :], a[:, q, :]  # rows: a <- J^T a
        a[:, p, :] = c[:, :, None] * ap - s[:, :, None] * aq
        a[:, q, :] = s[:, :, None] * ap + c[:, :, None] * aq
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(v, -1, order[:, None, :].expand_as(v)))


class _Eigvalsh(torch.autograd.Function):
    """Ascending eigenvalues with the backward V diag(dw) V^T; by
    ``torch.linalg.eigh``, or under ``jacobi`` by ``jacobi_eigh``."""

    @staticmethod
    def forward(ctx, a, jacobi: bool):
        a = (a + a.transpose(-1, -2)) / 2.0
        if jacobi:
            n = a.shape[-1]
            w, v = jacobi_eigh(a.reshape(-1, n, n))
            w, v = w.reshape(a.shape[:-1]), v.reshape(a.shape)
        else:
            w, v = torch.linalg.eigh(a)
        ctx.save_for_backward(v)
        return w

    @staticmethod
    def backward(ctx, dw):
        (v,) = ctx.saved_tensors
        return (v * dw[..., None, :]) @ v.transpose(-1, -2), None


def _safe_sqrt(x):
    ok = x > _EIG_FLOOR
    return torch.where(ok, torch.sqrt(torch.where(ok, x, _EIG_FLOOR)),
                       torch.zeros_like(x))


def _secular(w, c, rho: float, iters: int = 40):
    """Ascending eigenvalues of diag(w) + rho c c^T by bisection over the
    interlacing intervals."""
    c2 = c * c
    lo = w
    hi = torch.cat([w[..., 1:], w[..., -1:] + rho * c2.sum(-1, keepdim=True)],
                   -1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        diff = w[..., None, :] - mid[..., :, None]
        diff = torch.where(diff.abs() < 1e-30, torch.full_like(diff, 1e-30),
                           diff)
        below = (1.0 + rho * (c2[..., None, :] / diff).sum(-1)) < 0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def polar(ar: Arith, x):
    """The hybrid Newton-Schulz polar factor of each (r, c) matrix, r <= c,
    after a Frobenius prescale."""
    x = x.float()
    x = ar.polar(x * torch.rsqrt((x * x).sum((-2, -1), keepdim=True) + 1e-30))
    for a, b, c in QUINTIC:
        g = ar.polar(ar.mm(x, x.transpose(-1, -2)))
        g2 = ar.polar(ar.mm(g, g.transpose(-1, -2)))
        h = ar.polar(b * g + c * g2)
        x = ar.polar(a * x + ar.mm(h, x))
    for _ in range(CUBIC_STEPS):
        xxt = ar.polar(ar.mm(x, x.transpose(-1, -2)))
        x = ar.polar(1.5 * x - 0.5 * ar.mm(xxt, x))
    return x


def interp_matrix(src: int, dst: int, device) -> torch.Tensor:
    """(dst, src) half-pixel linear resampling weights
    (``F.interpolate(mode='linear', align_corners=False)``)."""
    x = np.maximum((np.arange(dst, dtype=np.float64) + 0.5) * src / dst - 0.5,
                   0.0)
    i0 = np.minimum(np.floor(x).astype(np.int64), src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    frac = x - i0
    w = np.zeros((dst, src))
    np.add.at(w, (np.arange(dst), i0), 1.0 - frac)
    np.add.at(w, (np.arange(dst), i1), frac)
    return torch.as_tensor(w.astype(np.float32), device=device)


def resample(ar: Arith, x, n: int, axis: int):
    src = x.shape[axis]
    if src == n:
        return x
    w = interp_matrix(src, n, x.device)
    return ar.mm(x.movedim(axis, -1), w.t()).movedim(-1, axis)


def cross_entropy(logits, targets, smoothing: float):
    c = logits.shape[-1]
    targets = targets * (1.0 - smoothing) + smoothing / c
    return -(targets * torch.log_softmax(logits, -1)).sum(-1).mean()


def selector(ar: Arith, teacher, student, t_imp, proj_s, proj_t, log_temps,
             rank_cap: int, jacobi: bool):
    """Mixing weights (P, L), mixed teacher tokens (P, B, N_t, D_t) with the
    CLS row, mixed importance (P, B, N_t - 1) and the ranks (L,).

    teacher: (L, B, N_t, D_t) block outputs with the CLS row, no grad;
    student: (P, B, N_s, D_s) tokens without it."""
    L = teacher.shape[0]
    d_s = proj_s.shape[0]
    t_patch = teacher[:, :, 1:].reshape(L, -1, teacher.shape[-1])
    m_t = t_patch.shape[1]
    mu_t_tok = t_patch.mean(1)
    tc = t_patch - mu_t_tok[:, None]
    g_t = ar.mm(ar.mm(proj_t, ar.mm(tc.transpose(-1, -2), tc)), proj_t.t())
    mu_t = mu_t_tok @ proj_t.t()
    s_flat = student.reshape(student.shape[0], -1, d_s)
    sc = s_flat - s_flat.mean(1, keepdim=True).detach()
    g_s = ar.mm(ar.mm(proj_s, ar.mm(sc.transpose(-1, -2), sc)), proj_s.t())

    w_all, v_all = _Eigh.apply(torch.cat([g_t.detach(), g_s], 0))
    c_t = torch.einsum("lds,ld->ls", v_all[:L].detach(), mu_t)
    w_cov = _secular(w_all[:L].detach(), c_t, float(m_t)) / m_t
    sigma2 = w_cov[:, (d_s - 1) // 2]
    lam_plus = sigma2 * (1.0 + (d_s / m_t) ** 0.5) ** 2
    ranks = (w_cov > lam_plus[:, None]).sum(-1).clamp(max=d_s - 1)
    ranks = ranks.clamp(max=rank_cap)

    basis_t = v_all[:L].flip(-1)[:, :, :rank_cap].detach()
    svals_t = _safe_sqrt(w_all[:L].flip(-1))[:, :rank_cap].detach()
    basis_s = v_all[L:].flip(-1)[:, :, :rank_cap]
    mask = (torch.arange(rank_cap, device=ranks.device) < ranks[:, None]).float()
    g = ar.mm(basis_s[:, None].transpose(-1, -2), basis_t[None])
    gm = mask[None, :, :, None] * g * mask[None, :, None, :]
    sigma = _safe_sqrt(_Eigvalsh.apply(ar.mm(gm, gm.transpose(-1, -2)),
                                       jacobi).flip(-1))
    theta = torch.arccos(sigma.clamp(max=1.0 - _EPS))
    sw = svals_t[None] * mask[None]
    d_sq = (sw * theta * theta).sum(-1) / sw.sum(-1).clamp(min=_EPS)
    tau = torch.nn.functional.softplus(log_temps)
    weights = torch.softmax(-d_sq / tau[:, None], dim=-1)
    mixed = torch.einsum("pl,lbnd->pbnd", weights, teacher)
    mixed_imp = torch.einsum("pl,lbn->pbn", weights, t_imp)
    return weights, mixed, mixed_imp, ranks


def procrustes(ar: Arith, s, t, imp):
    """Identity-form attention-weighted Procrustes loss per (P, B):
    tr(S_w^T S_w) + tr(T_w^T T_w) - 2 ||S_w^T T_w||_* with weighted-centred,
    sqrt(w)-scaled panels, the teacher shifted by the constant mean of the
    first 64 images; the nuclear norm's factor held constant."""
    n = s.shape[-2]
    w = resample(ar, imp.float(), n, -1)
    w = w / w.sum(-1, keepdim=True)
    k = min(t.shape[-3], 64)
    shift = t[..., :k, :, :].detach().mean(dim=(-3, -2), keepdim=True)
    mu_s = torch.einsum("...n,...nd->...d", w, s)
    s_c = s - mu_s[..., None, :]
    sw2 = w[..., None] * s_c
    tr_s = (sw2 * s_c).sum((-1, -2))
    t_c = t - shift
    mu_t = torch.einsum("...n,...nd->...d", w, t_c)
    tr_t = (w * (t_c * t_c).sum(-1)).sum(-1) - (mu_t * mu_t).sum(-1)
    cross = ar.mm(sw2.transpose(-1, -2), t_c)
    shape = cross.shape
    p = polar(ar, cross.detach().reshape(-1, *shape[-2:])).reshape(shape)
    return tr_s + tr_t - 2.0 * (p * cross).sum((-2, -1))


def basd_loss(ar: Arith, logits, targets, student_tokens, teacher, t_imp,
              buffers, log_temps, rank_cap: int, smoothing: float,
              backend: str):
    """(loss, parts) of one step; ``backend`` the selector's spectral
    backend ('gram' or 'jacobi')."""
    weights, mixed, mixed_imp, ranks = selector(
        ar, teacher, student_tokens, t_imp, buffers["proj_s"],
        buffers["proj_t"], log_temps, rank_cap, backend == "jacobi")
    n_s = student_tokens.shape[2]
    if teacher.shape[2] - 1 == n_s:
        # the mixed CLS row stays, with zero weight, against a zero row
        t_pan = mixed
        s_pan = torch.cat([torch.zeros_like(student_tokens[:, :, :1]),
                           student_tokens], 2)
        w_pan = torch.cat([torch.zeros_like(mixed_imp[..., :1]), mixed_imp], -1)
    else:
        t_pan = resample(ar, mixed[:, :, 1:], n_s, 2)
        s_pan, w_pan = student_tokens, mixed_imp
    geo = procrustes(ar, s_pan, t_pan, w_pan).mean(-1).mean()
    ce = cross_entropy(logits, targets, smoothing)
    vals = torch.stack([ce, geo])
    inv = 1.0 / vals.detach().clamp(min=_EPS)
    loss = ((inv / inv.sum()) * vals).sum()
    return loss, {"ce": ce.detach(), "geo": geo.detach(), "ranks": ranks,
                  "mix_weights": weights.detach()}
