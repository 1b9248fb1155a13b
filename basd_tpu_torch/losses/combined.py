"""Combined BASD loss: CE + mean per-extraction-point Procrustes, UW-SO
balanced (counterpart of ``basd_tpu/losses/combined.py``: every spectral
backend and relational impl, packed and dense branches)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from basd_tpu_torch.losses.selector import (
    SelectorConfig,
    init_selector,
    packed_gram_eligible,
    select_and_mix,
)
from basd_tpu_torch.models.tokens import PackedTokens
from basd_tpu_torch.ops.interp import align_token_count, linear_interp1d
from basd_tpu_torch.ops.losses import cross_entropy, uwso_combine, uwso_weights
from basd_tpu_torch.ops.procrustes import (
    geometric_relational_loss,
    geometric_relational_loss_ident,
)
from basd_tpu_torch.parallel.mesh import DataParallel
from basd_tpu_torch.utils import trace


def extraction_layers(student_depth: int, num_points: int) -> list[int]:
    """Evenly spaced extraction indices (Python banker's rounding)."""
    if num_points == 1:
        return [student_depth - 1]
    return [round(i * (student_depth - 1) / (num_points - 1))
            for i in range(num_points)]


@dataclass(frozen=True)
class BASDLossConfig:
    student_dim: int
    teacher_dim: int
    student_depth: int
    num_student_tokens: int
    num_extraction_points: int
    label_smoothing: float
    teacher_has_cls_token: bool
    backend: str = "gram"
    max_rank: int | None = None
    relational_impl: str = "ident"

    @property
    def token_layers(self) -> list[int]:
        return extraction_layers(self.student_depth, self.num_extraction_points)

    @property
    def selector_config(self) -> SelectorConfig:
        return SelectorConfig(
            num_extraction_points=self.num_extraction_points,
            student_dim=self.student_dim,
            teacher_dim=self.teacher_dim,
            backend=self.backend,
            max_rank=self.max_rank,
        )


def init_basd_loss(generator: torch.Generator, cfg: BASDLossConfig):
    """(params, buffers) of the loss: the selector state."""
    return init_selector(generator, cfg.selector_config)


def basd_loss(params, buffers, student_logits, targets, student_intermediates,
              teacher_tokens, teacher_importance, cfg: BASDLossConfig,
              dp: DataParallel | None = None):
    """Full BASD objective.

    Args:
        student_intermediates: (P, B, N_s, D_s) tokens at the extraction
            points (CLS stripped), ordered as ``cfg.token_layers``.
        teacher_tokens: (L, B, N_t, D_t) or ``PackedTokens``.
        teacher_importance: (L, B, N_t) reduced attention importance.
        targets: (B,) int labels or (B, C) soft (mixed) targets.
        dp: the data-parallel group whose shard B is: the loss is then
            the global batch's, the same on every rank (``parallel.mesh``).

    Returns ``(loss, aux)``.
    """
    dp = dp or DataParallel()
    ce = dp.mean(cross_entropy(student_logits, targets, cfg.label_smoothing))
    # the packed collection rides the hot path only under the fused Gram
    # selector (the predicate select_and_mix gates on) AND the identity-form
    # relational loss, which zero-weights the mixed CLS row; otherwise it
    # is densified first (reference combined.py:110-123)
    if isinstance(teacher_tokens, PackedTokens) and not (
            packed_gram_eligible(teacher_tokens, cfg.selector_config,
                                 dp.world)
            and cfg.relational_impl == "ident"):
        teacher_tokens = teacher_tokens.to_dense()
    packed = isinstance(teacher_tokens, PackedTokens)

    with trace.span("selector"):
        mixed_tokens, mixed_importance, sel_aux = select_and_mix(
            params, buffers, student_intermediates, teacher_tokens,
            teacher_importance, cfg.selector_config, dp,
        )

    if packed:
        if teacher_tokens.num_patch_tokens == cfg.num_student_tokens:
            # the mixed CLS row at n = 0 gets ZERO Procrustes weight
            # instead of being stripped; the student panel gets a dead zero
            # row to keep token indices aligned
            t_pan = mixed_tokens
            if teacher_tokens.has_cls:
                s_pan = torch.cat(
                    [torch.zeros_like(student_intermediates[:, :, :1]),
                     student_intermediates], dim=2)
                w_pan = torch.cat(
                    [torch.zeros_like(mixed_importance[..., :1]),
                     mixed_importance], dim=-1)
            else:
                s_pan, w_pan = student_intermediates, mixed_importance
        else:
            patches = (mixed_tokens[:, :, 1:] if teacher_tokens.has_cls
                       else mixed_tokens)
            t_pan = linear_interp1d(patches, cfg.num_student_tokens, axis=2)
            s_pan, w_pan = student_intermediates, mixed_importance
    else:
        t_pan = align_token_count(
            mixed_tokens.reshape((-1,) + tuple(mixed_tokens.shape[2:])),
            cfg.num_student_tokens,
        ).reshape(tuple(mixed_tokens.shape[:2])
                  + (cfg.num_student_tokens, -1))
        s_pan, w_pan = student_intermediates, mixed_importance

    with trace.span("procrustes"):
        if (cfg.backend in ("gram", "jacobi")
                and cfg.relational_impl == "ident"):
            geo_per_point = geometric_relational_loss_ident(
                s_pan, t_pan, w_pan, nuclear_backend=cfg.backend, dp=dp
            ).mean(-1)
        else:
            # the reference-shaped composition, one extraction point at a
            # time (the reference's jax.vmap over P)
            geo_per_point = torch.stack([
                geometric_relational_loss(s, t, w,
                                          nuclear_backend=cfg.backend)
                for s, t, w in zip(s_pan, t_pan, w_pan)
            ])
    geo_per_point = dp.mean(geo_per_point)
    geo = geo_per_point.mean()
    vals = torch.stack([ce, geo])
    loss = uwso_combine(vals)
    aux = {
        "ce_loss": ce,
        "geo_loss": geo,
        "geo_per_point": geo_per_point,
        "uwso_weights": uwso_weights(vals),
        **sel_aux,
    }
    return loss, aux
