"""One whole train step of the port against the JAX package's, f32, on
given views (teacher -> student -> BASD loss -> grads -> schedule-free
update), and a tiny end-to-end CPU run of the port's CLI entry point."""

from __future__ import annotations

import copy
import functools
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.config import compose, register_resolvers
from basd_tpu.losses import combined as jcombined
from basd_tpu.models.vit import ViTConfig as JViTConfig
from basd_tpu.models.vit import VisionTransformer as JViT
from basd_tpu.training import schedulefree as jsf
from basd_tpu_torch.models.port import selector_state_from_jax, state_dict_from_jax
from basd_tpu_torch.models.registry import create_model
from basd_tpu_torch.training import schedulefree as sf
from basd_tpu_torch.training.trainer import StepViews, Trainer
from basd_tpu_torch.train import _CONFIG_DIR, main

B, C, IMG = 8, 10, 32
T_ARCH = dict(embed_dim=64, depth=4, num_heads=4)
S_ARCH = dict(embed_dim=32, depth=4, num_heads=2)


def _f32_polar(monkeypatch):
    """Both packages' polar factor in f32 (see test_torch_losses.py)."""
    from basd_tpu.ops import linalg as jlinalg
    from basd_tpu_torch.ops import linalg

    monkeypatch.setattr(jlinalg, "newton_schulz_polar", functools.partial(
        jlinalg.newton_schulz_polar, inner_dtype=jnp.float32))
    monkeypatch.setattr(linalg, "newton_schulz_polar", functools.partial(
        linalg.newton_schulz_polar, inner_dtype=torch.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_step_on_views_matches_jax(monkeypatch, tmp_path):
    _f32_polar(monkeypatch)
    register_resolvers()
    config = compose(_CONFIG_DIR, overrides=[
        "experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
        f"model.vit.img_size={IMG}", "model.vit.patch_size=8",
        "model.drop_path_rate=0.0", "basd.teacher_model_name=tiny_teacher",
    ])
    rng = np.random.default_rng(21)
    clean = jnp.asarray(rng.standard_normal((B, IMG, IMG, 3)), jnp.float32
                        ).astype(jnp.bfloat16)
    mixed = jnp.asarray(rng.standard_normal((B, IMG, IMG, 3)), jnp.float32
                        ).astype(jnp.bfloat16)
    targets = jnp.asarray(rng.dirichlet(np.ones(C), B), jnp.float32)
    labels = rng.integers(0, C, B)

    # --- the JAX package's step, composed from its parts ---------------
    kw = dict(img_size=IMG, patch_size=8)
    jteacher = JViT(JViTConfig(num_classes=0, **kw, **T_ARCH),
                    importance_mode="cls", collect_alias=True)
    jstudent = JViT(JViTConfig(num_classes=C, **kw, **S_ARCH))
    t_vars = jteacher.init(jax.random.PRNGKey(0), clean)
    s_vars = jstudent.init(jax.random.PRNGKey(1), mixed)
    jcfg = jcombined.BASDLossConfig(
        student_dim=32, teacher_dim=64, student_depth=4,
        num_student_tokens=(IMG // 8) ** 2, num_extraction_points=4,
        label_smoothing=float(config.training.label_smoothing),
        teacher_has_cls_token=True)
    sel_params, sel_buffers = jcombined.init_basd_loss(jax.random.PRNGKey(2), jcfg)
    sf_cfg = jsf.ScheduleFreeConfig(
        learning_rate=float(config.training.learning_rate),
        weight_decay=float(config.training.weight_decay))
    state = jsf.init({"student": s_vars["params"], "basd": sel_params})
    out_t = jteacher.apply(t_vars, clean)
    y = jsf.train_params(state, sf_cfg)

    def loss_fn(trainable):
        out = jstudent.apply({"params": trainable["student"]}, mixed)
        s_int = jnp.stack([out["tokens"][i] for i in jcfg.token_layers])
        return jcombined.basd_loss(trainable["basd"], sel_buffers,
                                   out["logits"], targets, s_int,
                                   out_t["tokens"], out_t["importance"], jcfg)

    (jloss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(y)
    new = jsf.update(state, grads, sf_cfg, y=y)

    # --- the port's step on the same weights and views ----------------
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
    temps, trainer.sel_buffers = selector_state_from_jax(sel_params, sel_buffers)
    for st in (trainer.opt_state.x, trainer.opt_state.z):
        st["basd.log_temperatures"] = temps["log_temperatures"].clone()

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))

    views = StepViews(clean=t(clean), mixed=t(mixed), targets=t(targets),
                      drop_masks=None)

    def flat(tree):
        sd = dict(state_dict_from_jax(tree["student"]))
        sd["basd.log_temperatures"] = torch.from_numpy(
            np.array(tree["basd"]["log_temperatures"]))
        return {(k if k.startswith("basd.") else "student." + k): v.numpy()
                for k, v in sd.items()}

    # gradients at y, leaf by leaf (rel 1e-3 of the leaf: eigh order)
    g_ref = flat(grads)
    t_tokens, t_imp = trainer.teacher_forward(views.clean)
    _, _, _, g_ours, _ = trainer.loss_and_grads(views, t_tokens, t_imp)
    assert g_ours.keys() == g_ref.keys()
    for k, r in g_ref.items():
        assert _rel(g_ours[k].numpy(), r) <= 1e-3, k

    state0 = copy.deepcopy(trainer.opt_state)
    m = trainer.step_on_views(views, torch.from_numpy(labels))
    loss = (m["loss_sum"] / m["count"]).item()
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert trainer.opt_state.k == int(new.k)
    ref_v = flat(new.v)
    # the first step's v is proportional to g^2, so its relative error is
    # twice the gradient's: twice the per-leaf gradient bound above
    for k, r in ref_v.items():
        assert _rel(trainer.opt_state.v[k].numpy(), r) <= 2e-3, ("v", k)

    # x and z: Adam's first step g / (sqrt(v) + eps) = g / (0.03 |g| + eps)
    # is ill-conditioned where |g| is within some hundred eps of zero, and
    # there it turns gradient differences well inside the rel 1e-3 above
    # into differences of the step's own size. So the update is held to
    # the JAX package's on the same (JAX) gradients, every element; the
    # step's own gradients are held above and its v = g^2 end to end.
    sf.update(state0, {k: torch.from_numpy(r) for k, r in g_ref.items()},
              trainer.sf_cfg)
    for field in ("x", "z", "v"):
        ours = getattr(state0, field)
        for k, r in flat(getattr(new, field)).items():
            assert _rel(ours[k].numpy(), r) <= 1e-4, (field, k)


@pytest.fixture
def one_thread():
    """One intra-op thread: the CLI run is thousands of small ops, which
    thrash when the test workers share the cores with many threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
def test_cli_runs_end_to_end_on_cpu(tmp_path):
    """``main`` on the CPU, tiny synthetic config on the packed path
    (B * N_patch >= D_s): finite step losses, checkpoints written."""
    trainer = main([
        "experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
        "data.batch_size=32", "+data.limit_train_batches=2",
        "+data.limit_eval_batches=1", "+eval.efficiency_batches=2",
    ], device="cpu")
    out = tmp_path / "smoke_synthetic"
    steps = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()
             if json.loads(line)["kind"] == "step"]
    assert len(steps) == 2 and all(math.isfinite(s["loss"]) for s in steps)
    assert (out / "checkpoints" / "final_model_weights.pt").exists()
    assert (out / "checkpoints" / "latest" / "custom_state.json").exists()
    assert trainer.opt_state.k == 2
    resumed = trainer.load_checkpoint(str(out / "checkpoints" / "latest"))
    assert resumed == 1 and trainer.opt_state.k == 2
