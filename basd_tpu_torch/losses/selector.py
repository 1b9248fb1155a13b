"""Spectrally adaptive Grassmannian layer selector (counterpart of
``basd_tpu/losses/selector.py``).

State: the frozen random-orthogonal projections ``proj_s`` (D_s, D_s) and
``proj_t`` (D_s, D_t) and one learnable log-temperature per extraction
point. Per step on the fused path (backends 'gram' and 'jacobi', M >= D_s):
centred Grams of the projected teacher layers (no grad) and student points
(differentiable), formed in token space and shifted by a stop-gradient
channel mean; ONE stacked (L+P, D_s, D_s) eigh (``torch.linalg.eigh`` for
every backend, as the reference keeps it on XLA); MP ranks from the teacher
spectra by a rank-one secular update; masked principal angles, whose
(P*L, r_cap, r_cap) Gram eigenvalues go to K8 under 'jacobi';
softmax(-d^2 / tau) mixing weights; the weighted layer mix of the teacher
tokens (K6) and importance. The 'svd' backend, and any backend below
M = D_s rows, take the reference's parity branch instead (projected
panels, per-panel decompositions).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from basd_tpu_torch.kernels.mix_stack import mix_fwd_plain, mix_stack
from basd_tpu_torch.models.tokens import PackedTokens
from basd_tpu_torch.ops.grassmann import (
    grassmann_subspace,
    rank_mask,
    spectral_grassmann_distance_sq,
)
from basd_tpu_torch.ops.linalg import (
    _safe_sqrt,
    orthogonal_matrix,
    rank_one_update_eigvals,
    safe_eigh,
)
from basd_tpu_torch.ops.mp_rank import marchenko_pastur_rank
from basd_tpu_torch.parallel.mesh import DataParallel


@dataclass(frozen=True)
class SelectorConfig:
    num_extraction_points: int
    student_dim: int
    teacher_dim: int
    backend: str = "gram"
    max_rank: int | None = None


def init_selector(generator: torch.Generator, cfg: SelectorConfig):
    """Returns (params, buffers): ``log_temperatures`` (P,) learnable, init
    ``log(e - 1)`` (softplus^-1(1)); frozen orthogonal ``proj_s``,
    ``proj_t``."""
    params = {
        "log_temperatures": torch.full(
            (cfg.num_extraction_points,), math.log(math.e - 1.0)
        )
    }
    buffers = {
        "proj_s": orthogonal_matrix(generator, cfg.student_dim, cfg.student_dim),
        "proj_t": orthogonal_matrix(generator, cfg.student_dim, cfg.teacher_dim),
    }
    return params, buffers


def temperatures(params: dict) -> torch.Tensor:
    return torch.nn.functional.softplus(params["log_temperatures"])


def _sandwich(proj, g):
    """proj G proj^T over a (K, D, D) batch."""
    return torch.matmul(torch.matmul(proj, g), proj.t())


def _centered_gram(toks: torch.Tensor, proj: torch.Tensor, m: int,
                   dp: DataParallel):
    """(K, D_s, D_s) centred Gram of the projected tokens of a (K, B, N, D)
    stack, and the (K, D_s) projected channel means, via the shift identity
    with a stop-gradient channel mean (both terms at the centred scale).
    ``m`` counts the global batch's rows; the channel mean and the Gram are
    summed over ``dp``'s shards."""
    mu_tok = dp.mean(toks.float().mean(dim=(1, 2)))  # (K, D)
    shift = mu_tok.detach()
    shifted = (toks - shift[:, None, None, :]).to(toks.dtype)
    flat = shifted.reshape(shifted.shape[0], -1, shifted.shape[-1]).float()
    gram = dp.sum(torch.matmul(flat.transpose(-1, -2), flat))
    mu_p = mu_tok @ proj.t()
    d = mu_p - shift @ proj.t()
    return _sandwich(proj, gram) - m * d[:, :, None] * d[:, None, :], mu_p


def _centered_gram_flat(flat: torch.Tensor, cls, proj: torch.Tensor, m: int,
                        dp: DataParallel):
    """``_centered_gram`` over the PATCH rows of a (K, B*N, D) packed
    collection, CLS rows excluded exactly via the (K, B, D) CLS slab:
    sum_patch t t^T = sum_all t t^T - sum_cls t t^T. ``m`` is the global
    batch's patch row count. No-grad (the teacher side)."""
    s_all = flat.float().sum(1)
    if cls is not None:
        s_all = s_all - cls.float().sum(1)
    mu_tok = dp.sum(s_all) / m
    shift = mu_tok.detach()
    shifted = (flat - shift[:, None, :]).to(flat.dtype).float()
    g = torch.matmul(shifted.transpose(-1, -2), shifted)
    if cls is not None:
        sc = (cls - shift[:, None, :]).to(flat.dtype).float()
        g = g - torch.matmul(sc.transpose(-1, -2), sc)
    g = dp.sum(g)
    mu_p = mu_tok @ proj.t()
    d = mu_p - shift @ proj.t()
    return _sandwich(proj, g) - m * d[:, :, None] * d[:, None, :], mu_p


def packed_gram_eligible(tokens, cfg: SelectorConfig, world: int = 1) -> bool:
    """THE predicate for the packed fast path (shared with
    ``losses.combined``): packed tokens, gram/jacobi backend, M >= D_s,
    M over the global batch of ``world`` equal shards."""
    return (
        isinstance(tokens, PackedTokens)
        and cfg.backend in ("gram", "jacobi")
        and tokens.batch * world * tokens.num_patch_tokens >= cfg.student_dim
    )


def select_and_mix(params, buffers, student_tokens, teacher_tokens,
                   teacher_importance, cfg: SelectorConfig,
                   dp: DataParallel | None = None):
    """Mix all teacher layers into one soft target per extraction point.

    Args:
        student_tokens: (P, B, N_s, D_s) student tokens at the P points.
        teacher_tokens: (L, B, N_t, D_t) frozen CLS-stripped tokens, or a
            ``PackedTokens`` collection WITH its CLS rows (the fast path).
        teacher_importance: (L, B, N_patch).

    Returns ``(mixed_tokens (P, B, N_t, D_t) — for packed input N_t
    includes the mixed CLS row at n=0 —, mixed_importance (P, B, N_patch),
    aux)``. With ``dp``, B is this rank's shard of the global batch: the
    subspaces, ranks and weights are the global batch's, the same on every
    rank, and the mixed tokens and importance this rank's rows.
    """
    dp = dp or DataParallel()
    proj_s, proj_t = buffers["proj_s"], buffers["proj_t"]
    d_s = cfg.student_dim
    packed = packed_gram_eligible(teacher_tokens, cfg, dp.world)
    if isinstance(teacher_tokens, PackedTokens) and not packed:
        teacher_tokens = teacher_tokens.to_dense()
    if packed:
        m_t = dp.world * teacher_tokens.batch * teacher_tokens.num_patch_tokens
        L = teacher_tokens.num_layers
        t_flat_all = teacher_tokens.flat.detach()
        t_cls = teacher_tokens.cls.detach() if teacher_tokens.has_cls else None
        tok_dtype = t_flat_all.dtype
    else:
        t_tokens = teacher_tokens.detach()
        L = t_tokens.shape[0]
        m_t = dp.world * t_tokens.shape[1] * t_tokens.shape[2]
        tok_dtype = t_tokens.dtype
    P = student_tokens.shape[0]
    t_imp = teacher_importance.detach()
    r_cap = min(cfg.max_rank or d_s, d_s)

    if cfg.backend in ("gram", "jacobi") and m_t >= d_s:
        # fused path: ONE stacked eigh covers the teacher subspaces (no
        # grad) and the student bases; MP ranks from the teacher spectra
        # by a rank-one secular update (Z^T Z = Gram_c + M mu mu^T). The
        # stacked (L+P, D_s, D_s) eigh stays on torch.linalg.eigh for every
        # backend (reference selector.py:333-338); 'jacobi' takes K8 only
        # for the principal-angle batch below.
        if packed:
            gram_tc, mu_t = _centered_gram_flat(t_flat_all, t_cls, proj_t,
                                                m_t, dp)
        else:
            gram_tc, mu_t = _centered_gram(t_tokens, proj_t, m_t, dp)
        m_s = dp.world * student_tokens.shape[1] * student_tokens.shape[2]
        gram_sc, _ = _centered_gram(student_tokens, proj_s, m_s, dp)

        stacked = torch.cat([gram_tc.detach(), gram_sc], dim=0)
        w_all, v_all = safe_eigh(stacked, "xla")  # ascending

        w_t_asc = w_all[:L].detach()
        c_t = torch.einsum("lds,ld->ls", v_all[:L].detach(), mu_t)
        w_cov = rank_one_update_eigvals(w_t_asc, c_t, float(m_t)) / m_t
        sigma2 = w_cov[:, (d_s - 1) // 2]
        lam_plus = sigma2 * (1.0 + (d_s / m_t) ** 0.5) ** 2
        raw_ranks = (w_cov > lam_plus[:, None]).sum(-1).to(torch.int32)
        ref_ranks = torch.clamp(raw_ranks, max=d_s - 1)
        ranks = torch.clamp(ref_ranks, max=r_cap)

        basis_t = v_all[:L].flip(-1)[:, :, :r_cap]
        svals_t = _safe_sqrt(w_all[:L].flip(-1))[:, :r_cap]
        basis_s = v_all[L:].flip(-1)[:, :, :r_cap]
    else:
        # parity path ('svd', or tiny M < D_s): materialise the projected
        # panels, as the reference does (layer_selector.py:51-56), of the
        # global batch (the shards' rows gathered in rank order)
        t_all = dp.gather(t_tokens, 1)
        s_all = dp.gather(student_tokens, 1)
        z_t = torch.matmul(t_all.reshape(L, -1, t_all.shape[-1]).float(),
                           proj_t.t())
        z_s = torch.matmul(s_all.reshape(P, -1, s_all.shape[-1]).float(),
                           proj_s.t())
        rank_impl = "jacobi" if cfg.backend == "jacobi" else "xla"
        ref_ranks = torch.clamp(marchenko_pastur_rank(z_t, impl=rank_impl),
                                max=d_s - 1)
        ranks = torch.clamp(ref_ranks, max=r_cap)
        basis_t, svals_t = grassmann_subspace(z_t, backend=cfg.backend)
        basis_t = basis_t.detach()[:, :, :r_cap]
        svals_t = svals_t.detach()[:, :r_cap]
        basis_s = grassmann_subspace(z_s, backend=cfg.backend)[0][:, :, :r_cap]
    masks = rank_mask(ranks, r_cap)

    d_sq = spectral_grassmann_distance_sq(
        basis_s[:, None], basis_t[None, :], svals_t[None, :], masks[None, :],
        backend=cfg.backend,
    )  # (P, L)
    tau = temperatures(params)
    weights = torch.softmax(-d_sq / tau[:, None], dim=-1)

    # weights cast to the token dtype before mixing (reference
    # src/losses/layer_selector.py:110)
    w_tok = weights.to(tok_dtype)
    if packed:
        mixed_tokens = mix_stack(w_tok, t_flat_all).reshape(
            P, teacher_tokens.batch, teacher_tokens.num_tokens, -1
        )
    else:
        mixed_tokens = mix_fwd_plain(w_tok, t_tokens)
    mixed_importance = torch.einsum(
        "pl,lbn->pbn", weights.to(teacher_importance.dtype), t_imp
    )
    aux = {
        "ranks": ranks,
        "rank_cap_hits": (ref_ranks > ranks).sum().to(torch.int32),
        "mix_weights": weights,
        "distances_sq": d_sq,
        "temperatures": tau,
    }
    return mixed_tokens, mixed_importance, aux
