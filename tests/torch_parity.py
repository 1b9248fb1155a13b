"""The JAX package's train step and the port's ``Trainer`` on the same
weights, composed from their parts as ``tests/test_torch_step.py`` does:
the tiny teacher (packed collection) and student of that test, f32, both
polar factors in f32. Used by ``test_torch_parallel.py`` and
``test_torch_trajectory.py``."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import jax
import jax.numpy as jnp

from basd_tpu.losses import combined as jcombined
from basd_tpu.models.vit import ViTConfig as JViTConfig
from basd_tpu.models.vit import VisionTransformer as JViT
from basd_tpu.training import schedulefree as jsf
from basd_tpu_torch.config import compose, register_resolvers
from basd_tpu_torch.models.port import selector_state_from_jax, state_dict_from_jax
from basd_tpu_torch.models.registry import create_model
from basd_tpu_torch.train import _CONFIG_DIR
from basd_tpu_torch.training.trainer import Trainer

B, C, IMG = 8, 10, 32
T_ARCH = dict(embed_dim=64, depth=4, num_heads=4)
S_ARCH = dict(embed_dim=32, depth=4, num_heads=2)


def f32_polar(monkeypatch) -> None:
    """Both packages' polar factor in f32 (see test_torch_losses.py)."""
    from basd_tpu.ops import linalg as jlinalg
    from basd_tpu_torch.ops import linalg

    monkeypatch.setattr(jlinalg, "newton_schulz_polar", functools.partial(
        jlinalg.newton_schulz_polar, inner_dtype=jnp.float32))
    monkeypatch.setattr(linalg, "newton_schulz_polar", functools.partial(
        linalg.newton_schulz_polar, inner_dtype=torch.float32))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


@dataclass
class Pair:
    """The two packages' step on the same weights: ``jax_step(state, clean,
    mixed, targets) -> (state, loss, grads)`` (jitted) with its initial
    ``state``, and the port's ``trainer``; ``jax_metrics_step`` is the same
    step returning ``(state, loss, aux, logits)``."""

    config: Any
    jax_step: Any
    state: Any
    trainer: Trainer
    jax_metrics_step: Any = None

    def flat(self, tree) -> dict:
        """A JAX trainable tree as the port's flat {name: numpy} dict."""
        sd = dict(state_dict_from_jax(tree["student"]))
        sd["basd.log_temperatures"] = torch.from_numpy(
            np.array(tree["basd"]["log_temperatures"]))
        return {(k if k.startswith("basd.") else "student." + k): v.numpy()
                for k, v in sd.items()}


def make_pair(tmp_path) -> Pair:
    register_resolvers()
    config = compose(_CONFIG_DIR, overrides=[
        "experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
        f"model.vit.img_size={IMG}", "model.vit.patch_size=8",
        "model.drop_path_rate=0.0", "basd.teacher_model_name=tiny_teacher",
        "data.dataset=synthetic/tiny",
    ])
    x0 = jnp.zeros((B, IMG, IMG, 3), jnp.bfloat16)
    kw = dict(img_size=IMG, patch_size=8)
    jteacher = JViT(JViTConfig(num_classes=0, **kw, **T_ARCH),
                    importance_mode="cls", collect_alias=True)
    jstudent = JViT(JViTConfig(num_classes=C, **kw, **S_ARCH))
    t_vars = jteacher.init(jax.random.PRNGKey(0), x0)
    s_vars = jstudent.init(jax.random.PRNGKey(1), x0)
    jcfg = jcombined.BASDLossConfig(
        student_dim=S_ARCH["embed_dim"], teacher_dim=T_ARCH["embed_dim"],
        student_depth=S_ARCH["depth"], num_student_tokens=(IMG // 8) ** 2,
        num_extraction_points=4,
        label_smoothing=float(config.training.label_smoothing),
        teacher_has_cls_token=True)
    sel_params, sel_buffers = jcombined.init_basd_loss(jax.random.PRNGKey(2),
                                                       jcfg)
    sf_cfg = jsf.ScheduleFreeConfig(
        learning_rate=float(config.training.learning_rate),
        weight_decay=float(config.training.weight_decay))
    state = jsf.init({"student": s_vars["params"], "basd": sel_params})

    def step(state, clean, mixed, targets):
        out_t = jteacher.apply(t_vars, clean)
        y = jsf.train_params(state, sf_cfg)

        def loss_fn(trainable):
            out = jstudent.apply({"params": trainable["student"]}, mixed)
            s_int = jnp.stack([out["tokens"][i] for i in jcfg.token_layers])
            loss, aux = jcombined.basd_loss(
                trainable["basd"], sel_buffers, out["logits"], targets, s_int,
                out_t["tokens"], out_t["importance"], jcfg)
            return loss, (aux, out["logits"])

        (loss, (aux, logits)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(y)
        return jsf.update(state, grads, sf_cfg, y=y), loss, grads, aux, logits

    @jax.jit
    def jax_step(state, clean, mixed, targets):
        return step(state, clean, mixed, targets)[:3]

    @jax.jit
    def jax_metrics_step(state, clean, mixed, targets):
        new, loss, _, aux, logits = step(state, clean, mixed, targets)
        return new, loss, aux, logits

    teacher = create_model("tiny_teacher", img_size=IMG,
                           arch_overrides=dict(T_ARCH, patch_size=8),
                           importance_mode="cls", collect=True)
    teacher.module.load_state_dict(state_dict_from_jax(t_vars["params"]))
    teacher.module.eval().requires_grad_(False)
    student = create_model("tiny_student", img_size=IMG, num_classes=C,
                           arch_overrides=dict(S_ARCH, patch_size=8))
    student.module.load_state_dict(state_dict_from_jax(s_vars["params"]))
    trainer = Trainer(config, student_bundle=student, teacher_bundle=teacher,
                      device=torch.device("cpu"),
                      dataset_stats=((0.5,) * 3, (0.25,) * 3),
                      teacher_stats=(teacher.mean, teacher.std))
    temps, trainer.sel_buffers = selector_state_from_jax(sel_params,
                                                         sel_buffers)
    for st in (trainer.opt_state.x, trainer.opt_state.z):
        st["basd.log_temperatures"] = temps["log_temperatures"].clone()
    return Pair(config, jax_step, state, trainer, jax_metrics_step)
