"""The end of the port's CLI run against the JAX package: the eval suite
(``run_eval_suite``, ``measure_efficiency``, ``metrics.json``), the export
to a timm-layout ``.pth`` both ways, and ``train.main`` on the CNN-to-ViT
path followed by the export and eval CLIs, on the CPU at small sizes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.config import compose as jcompose
from basd_tpu.config import register_resolvers as jregister
from basd_tpu.evaluation import metrics as jmetrics
from basd_tpu.models import export as jexport
from basd_tpu.models import registry as jreg
from basd_tpu.parallel.mesh import make_mesh
from basd_tpu_torch import eval as eval_cli
from basd_tpu_torch.config import compose, register_resolvers
from basd_tpu_torch.evaluation import metrics
from basd_tpu_torch.models import registry
from basd_tpu_torch.models.export import main as export_main
from basd_tpu_torch.models.export import load_student_weights, save_torch_checkpoint
from basd_tpu_torch.models.port import state_dict_from_jax
from basd_tpu_torch.train import _CONFIG_DIR, main as train_main

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    thrash when the test workers share the cores with many threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
S_ARCH = dict(embed_dim=48, depth=2, num_heads=2, mlp_ratio=2.0)


def _structure(tree):
    """Nested key structure of a metrics dict (leaves become their type
    group: a string or a number)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return "str" if isinstance(tree, str) else "number"


def _jax_student(img: int, num_classes: int, seed: int):
    bundle = jreg.create_model("deit_tiny_patch16_224", img_size=img,
                               num_classes=num_classes, arch_overrides=S_ARCH,
                               dtype=jnp.float32)
    return bundle, jreg.init_model(bundle, jax.random.PRNGKey(seed), img)


def _port_student(params, img: int, num_classes: int):
    bundle = registry.create_model("deit_tiny_patch16_224", img_size=img,
                                   num_classes=num_classes, arch_overrides=S_ARCH)
    bundle.module.load_state_dict(state_dict_from_jax(params))
    return bundle


def test_eval_suite_matches_jax(tmp_path):
    """The primary dataset and a class-remapped robustness subset: equal
    accuracies and CE of the same f32 student, the reference's metrics.json
    keys, and ``measure_efficiency``'s parameter count equal to the JAX
    package's (GFLOPs are counted differently: positive both)."""
    overrides = ["experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
                 "data.dataset=synthetic/tiny", "data.batch_size=8",
                 "data.eval_datasets=[synthetic/tiny_subset]",
                 "model.vit.img_size=32", "model.vit.patch_size=16"]
    jregister()
    register_resolvers()
    jcfg = jcompose(_CONFIG_DIR, overrides=overrides)
    cfg = compose(_CONFIG_DIR, overrides=overrides)
    jbundle, jvars = _jax_student(32, 10, seed=0)
    ref = jmetrics.run_eval_suite(
        lambda p, x: jbundle.module.apply({"params": p}, x,
                                          deterministic=True)["logits"],
        jvars["params"], jcfg, mesh=make_mesh(data=1), config_path="cfg.yaml",
        efficiency_batches=2)
    model = _port_student(jvars["params"], 32, 10).module
    ours = metrics.run_eval_suite(model, cfg, config_path="cfg.yaml",
                                  efficiency_batches=2)
    assert _structure(ours) == _structure(ref)
    pairs = [(ours["primary"], ref["primary"])] + [
        (ours["robustness"][k], ref["robustness"][k]) for k in ref["robustness"]]
    for a, r in pairs:
        assert a["val_acc"] == r["val_acc"] and a["val_acc_top5"] == r["val_acc_top5"]
        assert abs(a["loss"] - r["loss"]) <= 1e-4 * abs(r["loss"])
    assert ours["efficiency"]["param_count"] == ref["efficiency"]["param_count"]
    assert ours["efficiency"]["gflops"] > 0 and ref["efficiency"]["gflops"] > 0
    assert ours["efficiency"]["throughput_img_per_sec"] > 0
    path = metrics.save_metrics(ours, tmp_path)
    assert json.loads(path.read_text()) == ours


def test_export_matches_timm_manifest(tmp_path):
    """The export of a DeiT-Tiny student carries exactly the real timm
    checkpoint's keys and shapes, in ``{epoch, model_state_dict}``."""
    from pathlib import Path

    bundle = registry.create_model("deit_tiny_patch16_224", img_size=224,
                                   num_classes=1000)
    registry.init_model(bundle, 5, fan_in_init=True)
    out = tmp_path / "student.pth"
    assert save_torch_checkpoint(out, bundle.module.state_dict(), epoch=7) == 152
    payload = torch.load(out, weights_only=True)
    assert payload["epoch"] == 7
    manifest = json.loads((Path(__file__).parent / "fixtures" / "manifests" /
                           "deit_tiny_patch16_224.json").read_text())
    sd = payload["model_state_dict"]
    assert {k: list(v.shape) for k, v in sd.items()} == manifest
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_export_roundtrip_between_packages(direction, tmp_path):
    """An export of one package loads as the other's teacher
    (``load_teacher(checkpoint_path=...)``, its arch derived from the
    shapes, ``num_heads`` declared as ``basd.teacher_arch`` would, the head
    dropped) and reproduces the exporter's per-layer f32 tokens; the port's
    ``load_student_weights`` takes the JAX export whole, head included
    (carries over ``test_port_and_data.py:623-715``)."""
    img, classes = 32, 10
    x = np.random.default_rng(8).standard_normal((2, img, img, 3)).astype(np.float32)
    jbundle, jvars = _jax_student(img, classes, seed=4)
    out = tmp_path / "student.pth"
    if direction == "port_to_jax":
        student = _port_student(jvars["params"], img, classes)
        save_torch_checkpoint(out, student.module.state_dict(), epoch=1)
        ref = student.module(torch.from_numpy(x))["tokens"].detach().numpy()
        tbundle, tvars = jreg.load_teacher(
            "exported_vit", img, checkpoint_path=str(out), dtype=jnp.float32,
            arch_overrides={"num_heads": S_ARCH["num_heads"]})
        tok, _ = jreg.teacher_extract(tbundle, tvars, jnp.asarray(x))
        got = np.asarray(tok.to_dense())
    else:
        jexport.save_torch_checkpoint(out, jvars["params"], epoch=1)
        ref_out = jbundle.module.apply(jvars, jnp.asarray(x))
        ref = np.asarray(ref_out["tokens"])
        teacher = registry.load_teacher(
            "exported_vit", img, device=CPU, checkpoint_path=str(out),
            dtype=torch.float32, arch_overrides={"num_heads": S_ARCH["num_heads"]})
        tok, _ = registry.teacher_extract(teacher, torch.from_numpy(x))
        got = tok.to_dense().numpy()
        student = registry.create_model("deit_tiny_patch16_224", img_size=img,
                                        num_classes=classes, arch_overrides=S_ARCH)
        assert load_student_weights(student.module, str(out)) == 1
        logits = student.module(torch.from_numpy(x))["logits"].detach().numpy()
        np.testing.assert_allclose(logits, np.asarray(ref_out["logits"]),
                                   rtol=0, atol=1e-5 * np.abs(ref_out["logits"]).max())
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)


def test_cross_arch_cli_then_export_and_eval_on_cpu(tmp_path, capsys):
    """``train.main`` with ``experiment=basd_imagenet_cross_arch`` (the
    ConvNeXtV2-Tiny teacher, 64 px, B=48 so that B * 4 teacher tokens >=
    D_s = 192 and the selector takes its Gram branch): no calibration (the
    preset student, D_s = 192), finite step losses, ``metrics.json`` with
    the reference's keys; then the export CLI on the final weights and the
    eval CLI on the ``.pth``, which reproduces the run's eval suite
    (``synthetic/tiny``'s 64 eval images, two batches; two timed forwards
    for the throughput)."""
    args = ["experiment=basd_imagenet_cross_arch",
            "data.dataset=synthetic/tiny", "data.source=synthetic",
            "data.eval_datasets=[]", "data.batch_size=48",
            "model.vit.img_size=64", "model.vit.patch_size=16",
            "training.num_epochs=1", "+eval.efficiency_batches=2"]
    trainer = train_main(args + [f"run.output_dir={tmp_path / 'train'}",
                                 "+data.limit_train_batches=2"], device="cpu")
    log = capsys.readouterr().out
    assert "student_arch_derived" not in log
    assert trainer.teacher.info["feature_format"] == "nhwc"
    assert trainer.student.info["embed_dim"] == 192
    assert trainer.loss_cfg.teacher_dim == 768
    run = tmp_path / "train" / "basd_imagenet_cross_arch"
    steps = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [s["loss"] for s in steps if s["kind"] == "step"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    trained = json.loads((run / "metrics.json").read_text())
    assert trained["efficiency"]["throughput_img_per_sec"] > 0
    assert _structure(trained) == {
        "run": {"name": "str", "config": "str"},
        "primary": {"dataset": "str", "val_acc": "number",
                    "val_acc_top5": "number", "loss": "number"},
        "robustness": {},
        "efficiency": {"param_count": "number", "param_count_m": "number",
                       "gflops": "number", "throughput_img_per_sec": "number"},
    }

    pth = tmp_path / "student.pth"
    export_main(args + [f"checkpoint.path={run / 'checkpoints' / 'final_model_weights'}",
                        f"+export.path={pth}"], device="cpu")
    evaluated = eval_cli.main(args + [f"run.output_dir={tmp_path / 'eval'}",
                                      f"checkpoint.path={pth}"], device="cpu")
    assert evaluated["primary"] == trained["primary"]
    assert (tmp_path / "eval" / "basd_imagenet_cross_arch" / "metrics.json").exists()
