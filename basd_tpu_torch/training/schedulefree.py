"""Schedule-free AdamW, functional (x, z, v) form (counterpart of
``basd_tpu/training/schedulefree.py``; Defazio et al., "The Road Less
Scheduled").

The state stores the averaged iterate ``x`` (eval/checkpoint weights), the
primal iterate ``z`` and the second moment ``v`` as dicts of tensors; the
gradient point ``y = b1 x + (1 - b1) z`` is formed each step::

    lr_t = lr * sched * sqrt(1 - b2^(k+1))
    c    = w_{k+1} / sum_i w_i,  w_i = i^r * lr_max^weight_lr_power
    v    = b2 v + (1 - b2) g^2
    u    = g / (sqrt(v) + eps) + weight_decay * y
    z   <- z - lr_t u
    x   <- (1 - c) x + c z
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from basd_tpu_torch.utils import trace


@dataclass(frozen=True)
class ScheduleFreeConfig:
    learning_rate: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 0
    r: float = 0.0
    weight_lr_power: float = 2.0


@dataclass
class ScheduleFreeState:
    x: dict  # averaged iterate (eval/checkpoint params)
    z: dict  # primal iterate
    v: dict  # second moment
    k: int = 0  # steps taken
    lr_max: float = 0.0
    weight_sum: float = 0.0


def init(params: dict) -> ScheduleFreeState:
    """``x`` is ``params``; ``z`` is a distinct copy (the two are updated
    separately)."""
    return ScheduleFreeState(
        x={k: p.detach().clone() for k, p in params.items()},
        z={k: p.detach().clone() for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
    )


def train_params(state: ScheduleFreeState, cfg: ScheduleFreeConfig) -> dict:
    """The gradient-evaluation point ``y = b1 x + (1 - b1) z``."""
    return {k: cfg.b1 * state.x[k] + (1.0 - cfg.b1) * state.z[k]
            for k in state.x}


def eval_params(state: ScheduleFreeState) -> dict:
    return state.x


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


@torch.no_grad()
def update(state: ScheduleFreeState, grads: dict, cfg: ScheduleFreeConfig,
           y: dict | None = None) -> ScheduleFreeState:
    """One step, in place on the state's tensors. ``grads`` are evaluated
    at ``train_params(state)``; pass that dict as ``y`` to skip
    recomputing it. The scalar schedule runs in f32, as the reference's."""
    with trace.span("update"):
        if y is None:
            y = train_params(state, cfg)
        k1 = state.k + 1
        k1f = _f32(k1)
        sched = (torch.clamp(k1f / cfg.warmup_steps, max=1.0)
                 if cfg.warmup_steps > 0 else _f32(1.0))
        bc2 = 1.0 - _f32(cfg.b2) ** k1f
        lr_t = cfg.learning_rate * sched * torch.sqrt(bc2)
        lr_max = torch.maximum(_f32(state.lr_max), lr_t)
        weight = k1f ** cfg.r * lr_max ** cfg.weight_lr_power
        weight_sum = _f32(state.weight_sum) + weight
        c = weight / weight_sum if float(weight_sum) > 0 else _f32(0.0)
        lr_t_f, c_f, omc_f = float(lr_t), float(c), float(1.0 - c)

        for key in state.x:
            g = grads[key].float()
            v_new = cfg.b2 * state.v[key].float() + (1.0 - cfg.b2) * (g * g)
            u = g / (torch.sqrt(v_new) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * y[key].float()
            z_new = state.z[key].float() - lr_t_f * u
            x_new = omc_f * state.x[key].float() + c_f * z_new
            state.x[key].copy_(x_new)
            state.z[key].copy_(z_new)
            state.v[key].copy_(v_new)
        state.k = k1
        state.lr_max = float(lr_max)
        state.weight_sum = float(weight_sum)
        return state
