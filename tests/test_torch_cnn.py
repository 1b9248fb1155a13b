"""The CNN-to-ViT path and teacher checkpoints of the port against the JAX
package: the ConvNeXtV2 and ResNet teachers (weights crossed by
``cnn_state_dict_from_jax``, and by one timm / torchvision-layout ``.pth``
both packages load), every vendored checkpoint manifest loaded strictly,
``derive_arch_from_state_dict`` and ``interpolate_pos_embed``, a DINOv2-layout
checkpoint, ``basd_loss`` on a dense CNN teacher stack, and one CNN-teacher
train step. Small custom architectures, 32-64 px, inputs from numpy seeds."""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.config import compose, register_resolvers
from basd_tpu.losses import combined as jcombined
from basd_tpu.models import port as jport
from basd_tpu.models import registry as jreg
from basd_tpu.models.vit import ViTConfig as JViTConfig
from basd_tpu.models.vit import VisionTransformer as JViT
from basd_tpu.training import schedulefree as jsf
from basd_tpu_torch.losses import BASDLossConfig, basd_loss
from basd_tpu_torch.models import port, registry
from basd_tpu_torch.models.port import (
    cnn_state_dict_from_jax,
    selector_state_from_jax,
    state_dict_from_jax,
)
from basd_tpu_torch.training.trainer import StepViews, Trainer
from basd_tpu_torch.train import _CONFIG_DIR

CPU = torch.device("cpu")
MANIFESTS = Path(__file__).parent / "fixtures" / "manifests"
ARCHS = {
    "convnext": dict(kind="convnext", depths=(1, 1, 2, 1), dims=(8, 16, 32, 64)),
    "resnet": dict(kind="resnet", stage_sizes=(1, 1, 1, 1), width=8),
}
# f32: the same arithmetic up to summation order; bf16: a few roundings of
# the last stage's activations (2^-5 of the feature scale)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -5}


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_extract(bundle, variables, x):
    """The JAX package's ``teacher_extract``, compiled once (op by op it
    takes seconds a call on the CPU)."""
    return jax.jit(lambda v, xs: jreg.teacher_extract(bundle, v, xs))(variables, x)


def _jax_cnn_variables(kind: str, img: int, seed: int, dtype=jnp.float32):
    """The JAX package's teacher at ``ARCHS[kind]`` with its 1-D leaves
    (biases, scales, GRN) and BatchNorm statistics moved off their init."""
    bundle = jreg.create_model(f"tiny_{kind}", img_size=img,
                               arch_overrides=ARCHS[kind], dtype=dtype)
    variables = jax.jit(lambda key: jreg.init_model(bundle, key, img))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if "batch_stats" in names:
            noise = rng.standard_normal(leaf.shape).astype(np.float32)
            return (0.1 * noise if names[-1] == "mean"
                    else 1.0 + 0.2 * np.abs(noise))
        if leaf.ndim == 1:
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    return bundle, jax.tree_util.tree_map_with_path(perturb, variables)


def _torch_layout_state_dict(kind: str, img: int, seed: int) -> dict:
    """A random state dict in timm's / torchvision's layout for
    ``ARCHS[kind]``, with the extra keys a real checkpoint carries."""
    bundle = registry.create_model(f"tiny_{kind}", img_size=img,
                                   arch_overrides=ARCHS[kind])
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in bundle.module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = 1.0 + 0.2 * torch.rand(v.shape, generator=g)
        elif v.dim() <= 1 or ".grn." in k:
            sd[k] = 1.0 * (k.endswith("weight") and ".grn." not in k) + \
                0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = torch.randn(v.shape, generator=g) * v[0].numel() ** -0.5
    c = ARCHS[kind].get("dims", (0,))[-1]
    if kind == "convnext":  # timm's pre-head and head norms
        for k in ("norm_pre", "head.norm"):
            sd[f"{k}.weight"], sd[f"{k}.bias"] = torch.ones(c), torch.zeros(c)
    else:  # torchvision's classifier
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 256), torch.zeros(10)
    return sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_cnn_teacher_extract_matches_jax(kind, dtype):
    """Tokens (1, B, H*W, C) and uniform importance of both packages'
    teacher, weights crossed by ``cnn_state_dict_from_jax``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jbundle, variables = _jax_cnn_variables(kind, 64, seed=1, dtype=jdt)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref_tok, ref_imp = _jax_extract(jbundle, variables, jnp.asarray(x).astype(jdt))

    bundle = registry.create_model(f"tiny_{kind}", img_size=64,
                                   arch_overrides=ARCHS[kind], dtype=dtype)
    bundle.module.load_state_dict(cnn_state_dict_from_jax(variables))
    tok, imp = registry.teacher_extract(bundle, torch.from_numpy(x).to(dtype))
    assert bundle.info == jbundle.info
    assert tok.shape == ref_tok.shape == (1, 2, 4, bundle.info["embed_dim"])
    assert tok.dtype == dtype
    assert _rel_err(tok.float().numpy(), _f32(ref_tok)) <= TOL[dtype]
    np.testing.assert_array_equal(imp.numpy(), _f32(ref_imp))


@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_cnn_checkpoint_both_packages_load(kind, tmp_path):
    """One timm / torchvision-layout ``.pth`` under an unlisted name: both
    packages derive the same arch from its shapes and give the same f32
    tokens; the head and pre-head keys are dropped."""
    path = tmp_path / f"{kind}.pth"
    torch.save(_torch_layout_state_dict(kind, 64, seed=3), path)
    # the reference's load_teacher for an unlisted name with a checkpoint
    # (registry.py:327-360), its init compiled once
    arch = jport.derive_arch_from_state_dict(jport._load_state_dict(str(path)))
    jbundle = jreg.create_model(f"custom_{kind}", img_size=64,
                                arch_overrides=arch, dtype=jnp.float32)
    jvars = jax.jit(lambda key: jreg.init_model(jbundle, key, 64))(
        jax.random.PRNGKey(0))
    jvars = jport.port_torch_checkpoint(str(path), jbundle, jvars)
    bundle = registry.load_teacher(f"custom_{kind}", 64, device=CPU,
                                   checkpoint_path=str(path), dtype=torch.float32)
    assert bundle.info == jbundle.info
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref_tok, _ = _jax_extract(jbundle, jvars, jnp.asarray(x))
    tok, _ = registry.teacher_extract(bundle, torch.from_numpy(x))
    assert _rel_err(tok.numpy(), _f32(ref_tok)) <= TOL[torch.float32]


def _manifest_state_dict(name: str) -> dict:
    """Random tensors with exactly a real checkpoint's keys and shapes."""
    manifest = json.loads((MANIFESTS / f"{name}.json").read_text())
    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, shape in manifest.items():
        if not shape:
            sd[k] = torch.tensor(1)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(shape, generator=g) * 0.02
    return sd


# the keys of a real checkpoint the port drops, as the reference ignores them
_DROPPED = {
    "convnextv2_tiny": ("norm_pre.", "head."),
    "dinov2_vitb14": ("mask_token",),
    "deit_tiny_patch16_224": ("head.",),
    "deit_small_patch16_224": ("head.",),
    "vit_large_patch16_224": ("head.",),
    "resnet50": ("fc.",),
}


@pytest.mark.parametrize("name", sorted(p.stem for p in MANIFESTS.glob("*.json")))
def test_every_manifest_loads_strictly(name):
    """Every vendored manifest (timm / dinov2 / torchvision key names and
    shapes) loads into the preset's port module with nothing missing and
    nothing unexpected once the ignored keys go; the position grid is
    resized to the model's (counterpart of ``test_port_and_data.py:267``)."""
    sd = _manifest_state_dict(name)
    img = 28 if "14" in name else 32
    bundle = registry.create_model(name, img_size=img)
    port.port_torch_checkpoint(sd, bundle)
    kept = {k for k in sd if not k.startswith(_DROPPED[name])}
    own = bundle.module.state_dict()
    assert set(own) == kept
    for k in kept - {"pos_embed"}:
        torch.testing.assert_close(own[k], sd[k].to(own[k].dtype), rtol=0, atol=0)
    if "pos_embed" in own:
        assert own["pos_embed"].shape[1] == bundle.cfg.num_tokens + 1


def _shapes(sd: dict) -> dict:
    return {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["deit_tiny_patch16_224", "dinov2_vitb14",
                                  "convnextv2_tiny", "resnet50", "ls"])
def test_derive_arch_matches_jax(name):
    """``derive_arch_from_state_dict`` gives the reference's dict for each
    layout, LayerScale under either naming, declared entries winning
    (counterpart of ``test_port_and_data.py:116``)."""
    if name == "ls":
        sd = _shapes(_manifest_state_dict("deit_small_patch16_224"))
        sd["blocks.0.gamma_1"] = np.ones(384, np.float32)
        declared = {"num_heads": 12}
    else:
        sd = _shapes(_manifest_state_dict(name))
        declared = None
    ours = port.derive_arch_from_state_dict(sd, declared=declared)
    assert ours == jport.derive_arch_from_state_dict(sd, declared=declared)
    with pytest.raises(ValueError, match="unrecognized"):
        port.derive_arch_from_state_dict({"foo.weight": np.ones(3)})


@pytest.mark.parametrize("n_src,target,has_cls", [
    (16, 64, True), (1369, 256, True), (256, 1369, False), (16, 16, True),
    (196, 49, False)])
def test_interpolate_pos_embed_matches_jax(n_src, target, has_cls):
    """The resize of ``jax.image.resize(..., 'linear')``: up, and down with
    its antialiasing (DINOv2's 37 x 37 grid onto 16 x 16), to f32 rounding
    (counterpart of ``test_port_and_data.py:138``)."""
    rng = np.random.default_rng(n_src + target)
    pos = rng.standard_normal((1, n_src + int(has_cls), 8)).astype(np.float32)
    ref = jport.interpolate_pos_embed(pos, target, has_cls=has_cls)
    ours = port.interpolate_pos_embed(pos, target, has_cls=has_cls).numpy()
    assert ours.shape == ref.shape == (1, target + int(has_cls), 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)
    if has_cls:
        np.testing.assert_array_equal(ours[:, 0], pos[:, 0])


def _dinov2_state_dict(d: int, depth: int, grid: int, naming: str) -> dict:
    """A DINOv2 hub-layout ViT (patch 14, LayerScale, mask_token) whose
    position grid was trained at ``grid`` x ``grid`` patches."""
    g = torch.Generator().manual_seed(5)

    def rn(*shape, scale=0.05):
        return torch.randn(shape, generator=g) * scale

    sd = {"cls_token": rn(1, 1, d), "pos_embed": rn(1, grid * grid + 1, d),
          "mask_token": torch.zeros(1, d),
          "patch_embed.proj.weight": rn(d, 3, 14, 14, scale=0.02),
          "patch_embed.proj.bias": rn(d), "norm.weight": 1.0 + rn(d),
          "norm.bias": rn(d)}
    for i in range(depth):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1.0 + rn(d), rn(d)
        for n, shape in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                         ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = rn(*shape), rn(shape[0])
        for j in (1, 2):
            key = f"{p}.ls{j}.gamma" if naming == "ls" else f"{p}.gamma_{j}"
            sd[key] = 0.5 + rn(d)
    return sd


@pytest.mark.parametrize("naming", ["ls", "gamma"])
def test_dinov2_checkpoint_matches_jax(naming, tmp_path):
    """A DINOv2-layout checkpoint (``ls1.gamma`` or the older ``gamma_1``
    naming, 37 x 37 grid, ``mask_token``) under an unlisted name, onto
    224 px / patch 14: the derived arch, the resized grid and the f32
    teacher tokens and importance equal the reference's."""
    path = tmp_path / "dinov2.pth"
    torch.save(_dinov2_state_dict(128, 2, 37, naming), path)
    jbundle, jvars = jreg.load_teacher("dinov2_custom", 224,
                                       checkpoint_path=str(path), dtype=jnp.float32)
    bundle = registry.load_teacher("dinov2_custom", 224, device=CPU,
                                   checkpoint_path=str(path), dtype=torch.float32)
    # the port's info also states the MLP, which the JAX package's lacks
    mlp = {k: bundle.info.pop(k) for k in ("mlp", "mlp_hidden")}
    assert mlp == {"mlp": "gelu", "mlp_hidden": 512}
    assert bundle.info == jbundle.info and bundle.info["num_tokens"] == 256
    np.testing.assert_allclose(bundle.module.pos_embed.detach().numpy(),
                               np.asarray(jvars["params"]["pos_embed"]),
                               rtol=0, atol=2e-6)
    x = np.random.default_rng(6).standard_normal((2, 224, 224, 3)).astype(np.float32)
    ref_tok, ref_imp = jreg.teacher_extract(jbundle, jvars, jnp.asarray(x))
    tok, imp = registry.teacher_extract(bundle, torch.from_numpy(x))
    assert _rel_err(tok.to_dense().numpy(), _f32(ref_tok.to_dense())) <= 1e-5
    assert _rel_err(imp.numpy(), _f32(ref_imp)) <= 1e-5


def _f32_polar(monkeypatch):
    """Both packages' polar factor in f32 (see test_torch_losses.py)."""
    from basd_tpu.ops import linalg as jlinalg
    from basd_tpu_torch.ops import linalg

    monkeypatch.setattr(jlinalg, "newton_schulz_polar", functools.partial(
        jlinalg.newton_schulz_polar, inner_dtype=jnp.float32))
    monkeypatch.setattr(linalg, "newton_schulz_polar", functools.partial(
        linalg.newton_schulz_polar, inner_dtype=torch.float32))


@pytest.mark.parametrize("backend", ["gram", "svd"])
def test_dense_cnn_teacher_basd_loss_matches_jax(backend, monkeypatch):
    """``basd_loss`` on a dense (1, B, 49, D_t) CNN stack with uniform
    importance, the 7 x 7 map resampled to the student's 196 tokens: loss,
    its parts and the gradients of the student tokens, logits and
    temperatures, f32 (counterpart of ``test_selector.py:411``). B * 49 >=
    D_s, so ``gram`` takes the fused-Gram branch."""
    _f32_polar(monkeypatch)
    rng = np.random.default_rng(31)
    b, ns, nt, ds, dt, p, c = 4, 196, 49, 32, 64, 2, 10
    student = rng.standard_normal((p, b, ns, ds)).astype(np.float32)
    teacher = rng.standard_normal((1, b, nt, dt)).astype(np.float32)
    imp = np.full((1, b, nt), 1.0 / nt, np.float32)
    logits = rng.standard_normal((b, c)).astype(np.float32)
    targets = rng.dirichlet(np.ones(c), b).astype(np.float32)
    kw = dict(student_dim=ds, teacher_dim=dt, student_depth=12,
              num_student_tokens=ns, num_extraction_points=p,
              label_smoothing=0.1, teacher_has_cls_token=False, backend=backend)
    jcfg = jcombined.BASDLossConfig(**kw)
    jparams, jbuffers = jcombined.init_basd_loss(jax.random.PRNGKey(0), jcfg)

    def jloss(params, s, lg):
        return jcombined.basd_loss(params, jbuffers, lg, jnp.asarray(targets), s,
                                   jnp.asarray(teacher), jnp.asarray(imp), jcfg)

    (ref, ref_aux), ref_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jparams, jnp.asarray(student), jnp.asarray(logits))

    params, buffers = selector_state_from_jax(jparams, jbuffers)
    leaves = [params["log_temperatures"].requires_grad_(True),
              torch.from_numpy(student).requires_grad_(True),
              torch.from_numpy(logits).requires_grad_(True)]
    loss, aux = basd_loss({"log_temperatures": leaves[0]}, buffers, leaves[2],
                          torch.from_numpy(targets), leaves[1],
                          torch.from_numpy(teacher), torch.from_numpy(imp),
                          BASDLossConfig(**kw))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(ref)) <= 1e-4 * abs(float(ref))
    for k in ("ce_loss", "geo_loss"):
        assert abs(aux[k].item() - float(ref_aux[k])) <= 1e-4 * abs(float(ref_aux[k])), k
    np.testing.assert_array_equal(aux["ranks"].numpy(), np.asarray(ref_aux["ranks"]))
    np.testing.assert_allclose(aux["mix_weights"].detach().numpy(), 1.0)
    refs = (ref_g[0]["log_temperatures"], ref_g[1], ref_g[2])
    for name, a, r in zip(("temps", "student", "logits"), grads, refs):
        assert _rel_err(a.numpy(), _f32(r)) <= 1e-3, name


def test_cnn_teacher_train_step_matches_jax(monkeypatch, tmp_path):
    """One train step with a ConvNeXtV2 teacher on given views, f32: every
    gradient at y, the loss and the schedule-free update against the JAX
    package's step composed from its parts (counterpart of
    ``test_train_e2e.py:397``; the ViT-teacher step is
    ``test_torch_step.py``)."""
    _f32_polar(monkeypatch)
    register_resolvers()
    b, c, img = 8, 10, 64
    s_arch = dict(embed_dim=32, depth=4, num_heads=2)
    config = compose(_CONFIG_DIR, overrides=[
        "experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
        f"model.vit.img_size={img}", "model.vit.patch_size=16",
        "model.drop_path_rate=0.0", "basd.teacher_model_name=tiny_convnext",
    ])
    rng = np.random.default_rng(23)
    # bf16 views, as the trainer hands the teacher (its forward casts the
    # clean view to bf16; the f32 teacher then computes on those values)
    clean = jnp.asarray(rng.standard_normal((b, img, img, 3)), jnp.float32
                        ).astype(jnp.bfloat16)
    mixed = jnp.asarray(rng.standard_normal((b, img, img, 3)), jnp.float32
                        ).astype(jnp.bfloat16)
    targets = jnp.asarray(rng.dirichlet(np.ones(c), b), jnp.float32)
    labels = rng.integers(0, c, b)

    jteacher, t_vars = _jax_cnn_variables("convnext", img, seed=7)
    jstudent = JViT(JViTConfig(img_size=img, patch_size=16, num_classes=c, **s_arch))
    s_vars = jstudent.init(jax.random.PRNGKey(1), mixed)
    jcfg = jcombined.BASDLossConfig(
        student_dim=32, teacher_dim=64, student_depth=4,
        num_student_tokens=(img // 16) ** 2, num_extraction_points=4,
        label_smoothing=float(config.training.label_smoothing),
        teacher_has_cls_token=False)
    sel_params, sel_buffers = jcombined.init_basd_loss(jax.random.PRNGKey(2), jcfg)
    sf_cfg = jsf.ScheduleFreeConfig(
        learning_rate=float(config.training.learning_rate),
        weight_decay=float(config.training.weight_decay))
    state = jsf.init({"student": s_vars["params"], "basd": sel_params})
    t_tok, t_imp = _jax_extract(jteacher, t_vars, clean)
    y = jsf.train_params(state, sf_cfg)

    def loss_fn(trainable):
        out = jstudent.apply({"params": trainable["student"]}, mixed)
        s_int = jnp.stack([out["tokens"][i] for i in jcfg.token_layers])
        return jcombined.basd_loss(trainable["basd"], sel_buffers, out["logits"],
                                   targets, s_int, t_tok, t_imp, jcfg)

    (jloss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(y)
    new = jsf.update(state, grads, sf_cfg, y=y)

    teacher = registry.create_model("tiny_convnext", img_size=img,
                                    arch_overrides=ARCHS["convnext"])
    teacher.module.load_state_dict(cnn_state_dict_from_jax(t_vars))
    teacher.module.eval().requires_grad_(False)
    student = registry.create_model("tiny_student", img_size=img, num_classes=c,
                                    arch_overrides=dict(s_arch, patch_size=16))
    student.module.load_state_dict(state_dict_from_jax(s_vars["params"]))
    trainer = Trainer(config, student_bundle=student, teacher_bundle=teacher,
                      device=CPU, dataset_stats=((0.5,) * 3, (0.25,) * 3),
                      teacher_stats=(teacher.mean, teacher.std))
    assert trainer.loss_cfg.teacher_dim == 64
    assert trainer.loss_cfg.teacher_has_cls_token is False
    temps, trainer.sel_buffers = selector_state_from_jax(sel_params, sel_buffers)
    for st in (trainer.opt_state.x, trainer.opt_state.z):
        st["basd.log_temperatures"] = temps["log_temperatures"].clone()

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))

    views = StepViews(clean=t(clean), mixed=t(mixed), targets=t(targets),
                      drop_masks=None)

    def flat(tree):
        sd = dict(state_dict_from_jax(tree["student"]))
        sd["basd.log_temperatures"] = t(tree["basd"]["log_temperatures"])
        return {(k if k.startswith("basd.") else "student." + k): v.numpy()
                for k, v in sd.items()}

    t_tokens, t_imp_ours = trainer.teacher_forward(views.clean)
    assert trainer._collect_buffer(b) is None
    assert t_tokens.shape == (1, b, 4, 64)
    assert _rel_err(t_tokens.numpy(), _f32(t_tok)) <= 1e-5
    # gradients at y, leaf by leaf (rel 1e-3 of the leaf: eigh order)
    g_ref = flat(grads)
    _, _, _, g_ours, _ = trainer.loss_and_grads(views, t_tokens, t_imp_ours)
    assert g_ours.keys() == g_ref.keys()
    for k, r in g_ref.items():
        assert _rel_err(g_ours[k].numpy(), r) <= 1e-3, k

    m = trainer.step_on_views(views, torch.from_numpy(labels))
    loss = (m["loss_sum"] / m["count"]).item()
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert trainer.opt_state.k == int(new.k)
    # the first step's v is proportional to g^2: twice the gradient's bound
    for k, r in flat(new.v).items():
        assert _rel_err(trainer.opt_state.v[k].numpy(), r) <= 2e-3, ("v", k)
