"""BASD trainer on one device (counterpart of
``basd_tpu/training/trainer.py``).

One distillation step:

    uint8 canvas -> dual views + MixUp/CutMix (draws from an explicit
    generator) -> frozen bf16 teacher forward (a ViT: K1/K2, per-layer
    tokens into one reused flat collect buffer, CLS importance; a CNN: its
    last feature map as one dense (1, B, H*W, C) layer, uniform importance)
    -> student forward and backward (K3/K4 per block, K5 final norm) ->
    BASD loss (selector with the K6 layer mix on the packed stack;
    identity-form Procrustes with the K7 polar factor; CE; UW-SO) ->
    schedule-free AdamW.

The step is split in two: ``make_views`` (draws and views) and
``step_on_views`` (the rest, on given views, so tests can feed both
packages the same inputs). The student module's parameters hold the
gradient point ``y`` during a step; the optimizer state holds x, z, v.
Epoch metrics accumulate on the device and cross to the host once per
epoch. Train accuracy uses the un-mixed labels.
"""

from __future__ import annotations

import itertools
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from basd_tpu_torch.data.pipeline import prefetch
from basd_tpu_torch.data import augment as aug
from basd_tpu_torch.evaluation import metrics as metrics_mod
from basd_tpu_torch.losses import BASDLossConfig, basd_loss, init_basd_loss
from basd_tpu_torch.models.registry import ModelBundle, teacher_extract
from basd_tpu_torch.models.vit import drop_path_rates
from basd_tpu_torch.training import schedulefree as sf
from basd_tpu_torch.utils import checkpoint as ckpt
from basd_tpu_torch.utils.logging import MetricsLogger

_STUDENT = "student."
_TEMPS = "basd.log_temperatures"


@dataclass
class StepViews:
    """Inputs of ``step_on_views``: the clean teacher view, the mixed
    student view and its soft targets, and the student's stochastic-depth
    draws ((depth, 2, B) bool, or None)."""

    clean: torch.Tensor
    mixed: torch.Tensor
    targets: torch.Tensor
    drop_masks: Optional[torch.Tensor]


class Trainer:
    def __init__(self, config, *, student_bundle: ModelBundle,
                 teacher_bundle: ModelBundle, device: torch.device,
                 dataset_stats: tuple, teacher_stats: tuple):
        self.config = config
        self.device = torch.device(device)
        self.student = student_bundle
        self.teacher = teacher_bundle
        self.student.module.to(self.device).train()
        self.dataset_stats = tuple(map(tuple, dataset_stats))
        self.teacher_stats = tuple(map(tuple, teacher_stats))
        self.img_size = config.model.vit.img_size
        self.num_classes = config.model.num_classes

        s_info = student_bundle.info
        self.loss_cfg = BASDLossConfig(
            student_dim=s_info["embed_dim"],
            teacher_dim=teacher_bundle.info["embed_dim"],
            student_depth=s_info["depth"],
            num_student_tokens=s_info["num_tokens"],
            num_extraction_points=config.basd.num_extraction_points,
            label_smoothing=config.training.label_smoothing,
            teacher_has_cls_token=teacher_bundle.info["has_cls_token"],
            backend=config.basd.get("spectral_backend", "gram"),
            max_rank=config.basd.get("max_rank"),
            relational_impl=config.basd.get("relational_impl", "ident"),
        )
        self.token_layers = self.loss_cfg.token_layers
        sel_params, sel_buffers = init_basd_loss(
            torch.Generator().manual_seed(config.run.seed + 1), self.loss_cfg
        )
        self.sel_buffers = {k: v.to(self.device) for k, v in sel_buffers.items()}
        trainable = {_STUDENT + k: p.detach()
                     for k, p in self.student.module.named_parameters()}
        trainable[_TEMPS] = sel_params["log_temperatures"].to(self.device)
        self.sf_cfg = sf.ScheduleFreeConfig(
            learning_rate=config.training.learning_rate,
            weight_decay=config.training.weight_decay,
        )
        self.opt_state = sf.init(trainable)

        self.best_val_acc = 0.0
        self.metrics_history: dict[str, list] = defaultdict(list)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.run.seed))
        out_dir = Path(config.run.output_dir) / config.run.name
        self._mlog = MetricsLogger(out_dir / "metrics.jsonl")
        self.source = None  # the data source of the last ``train`` call
        # the teacher's (L*B*N, D) collect buffer: allocated once per batch
        # size, every slab overwritten by each step's teacher forward
        self._collect_buf: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ the step

    def _collect_buffer(self, b: int) -> Optional[torch.Tensor]:
        """The collecting ViT teacher's buffer; None for a CNN teacher,
        whose one dense "layer" is its last feature map."""
        module = self.teacher.module
        if not getattr(module, "collect", False):
            return None
        cfg = module.cfg
        n = cfg.num_patches + (1 if cfg.use_cls_token else 0)
        shape = (cfg.depth * b * n, cfg.embed_dim)
        if self._collect_buf is None or tuple(self._collect_buf.shape) != shape:
            self._collect_buf = torch.empty(shape, dtype=module.compute_dtype,
                                            device=self.device)
        return self._collect_buf

    def make_views(self, images_u8: torch.Tensor,
                   labels: torch.Tensor) -> StepViews:
        b = images_u8.shape[0]
        g = self.generator
        clean, augmented = aug.make_train_views(
            aug.draw_train_views(g, b, self.device), images_u8, self.img_size,
            self.dataset_stats, self.teacher_stats,
        )
        mixed, targets = aug.mixup_cutmix(
            aug.draw_mixup(g, self.img_size, self.device), augmented, labels,
            self.num_classes,
        )
        cfg = self.student.cfg
        drop_masks = None
        if cfg.drop_path_rate > 0.0:
            keeps = torch.as_tensor(1.0 - drop_path_rates(cfg),
                                    device=self.device)
            u = torch.rand((cfg.depth, 2, b), generator=g, device=self.device)
            drop_masks = u < keeps[:, None, None]
        return StepViews(clean, mixed, targets, drop_masks)

    def teacher_forward(self, clean: torch.Tensor):
        return teacher_extract(
            self.teacher, clean.to(torch.bfloat16),
            collection_init=self._collect_buffer(clean.shape[0]),
        )

    def loss_and_grads(self, views: StepViews, t_tokens, t_imp):
        """Loss, aux and gradients at the schedule-free point ``y``."""
        y = sf.train_params(self.opt_state, self.sf_cfg)
        params = dict(self.student.module.named_parameters())
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(y[_STUDENT + k])
        temps = y[_TEMPS].clone().requires_grad_(True)
        out = self.student.module(
            views.mixed.to(torch.bfloat16), deterministic=False,
            drop_masks=views.drop_masks,
        )
        s_int = torch.stack([out["tokens"][i] for i in self.token_layers])
        loss, aux = basd_loss(
            {"log_temperatures": temps}, self.sel_buffers, out["logits"],
            views.targets, s_int, t_tokens, t_imp, self.loss_cfg,
        )
        wrt = list(params.values()) + [temps]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        names = [_STUDENT + k for k in params] + [_TEMPS]
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for k, p, g in zip(names, wrt, grads)}
        return loss.detach(), aux, out["logits"].detach(), grads, y

    def step_on_views(self, views: StepViews, labels: torch.Tensor) -> dict:
        """Teacher -> student -> loss -> grads -> schedule-free update."""
        try:
            t_tokens, t_imp = self.teacher_forward(views.clean)
            loss, aux, logits, grads, y = self.loss_and_grads(
                views, t_tokens, t_imp)
            sf.update(self.opt_state, grads, self.sf_cfg, y=y)
        except BaseException:
            # a failed step may have left the reused buffer half written
            self._collect_buf = None
            raise
        valid = labels >= 0
        n = valid.sum()
        return {
            "loss_sum": loss * n,
            "correct": ((logits.argmax(-1) == labels) & valid).sum(),
            "count": n,
            "ce": aux["ce_loss"].detach(),
            "geo": aux["geo_loss"].detach(),
            "ranks": aux["ranks"],
            "rank_cap_hits": aux["rank_cap_hits"],
            "mix_weights": aux["mix_weights"].detach(),
        }

    def step(self, images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        with torch.no_grad():
            views = self.make_views(images_u8, labels)
        return self.step_on_views(views, labels)

    # ------------------------------------------------------------- loops

    def to_device(self, batch: dict):
        return (torch.from_numpy(batch["image"]).to(self.device),
                torch.from_numpy(batch["label"]).to(self.device))

    def device_batches(self, source, split: str, *, seed: int, shuffle: bool,
                       drop_last: bool, limit: Optional[int] = None):
        """Yield ``(uint8 canvas, labels)`` of ``split`` on the device: the
        source's batches at the eval-crop canvas size, prefetched on a host
        thread, at most ``limit`` of them."""
        cfg = self.config
        r = round(self.img_size / cfg.data.eval_crop_ratio)
        batches = source.load_batches(split, cfg.data.batch_size, r,
                                      shuffle=shuffle, seed=seed,
                                      drop_last=drop_last)
        for batch in itertools.islice(prefetch(batches), limit):
            yield self.to_device(batch)

    def train_epoch(self, source, epoch: int) -> dict[str, float]:
        cfg = self.config
        acc = None
        step_losses = []
        for images, labels in self.device_batches(
                source, "train", seed=cfg.run.seed * 100003 + epoch,
                shuffle=True, drop_last=True,
                limit=cfg.data.get("limit_train_batches")):
            m = self.step(images, labels)
            step_losses.append(m["loss_sum"] / m["count"])
            totals = {k: m[k] for k in ("loss_sum", "correct", "count",
                                        "rank_cap_hits")}
            acc = metrics_mod.accumulate(acc, totals)
        if acc is None:
            host = {"loss_sum": 0.0, "correct": 0, "count": 0,
                    "rank_cap_hits": 0}
        else:
            host = {k: v.item() for k, v in acc.items()}
        losses = torch.stack(step_losses).tolist() if step_losses else []
        for i, v in enumerate(losses):
            self._mlog.log("step", epoch=epoch + 1, step=i, loss=v)
        cap_hits = int(host["rank_cap_hits"])
        if cap_hits:
            msg = (
                f"rank_cap_warning epoch={epoch + 1} hits={cap_hits} "
                f"cap={self.loss_cfg.max_rank}: MP ranks exceeded "
                f"basd.max_rank; loss uses truncated subspaces (raise "
                f"basd.max_rank or set it to null for exact reference "
                f"semantics)"
            )
            print(msg, file=sys.stderr)
            if cfg.basd.get("error_on_rank_cap", False):
                raise RuntimeError(msg)
        total = max(int(host["count"]), 1)
        return {
            "train_loss": float(host["loss_sum"]) / total,
            "train_acc": 100.0 * int(host["correct"]) / total,
            "rank_cap_hits": cap_hits,
            "step_losses": losses,
        }

    def _load_student(self, params: dict) -> None:
        with torch.no_grad():
            for k, p in self.student.module.named_parameters():
                p.copy_(params[_STUDENT + k])

    def eval_student(self) -> torch.nn.Module:
        """The student module, holding the schedule-free eval point x."""
        self._load_student(sf.eval_params(self.opt_state))
        return self.student.module

    def evaluate(self, source, *, split: str = "eval", valid_indices=None,
                 label_smoothing: float | None = None) -> dict[str, float]:
        cfg = self.config
        ls = (cfg.training.label_smoothing if label_smoothing is None
              else label_smoothing)
        step = metrics_mod.make_eval_step(
            metrics_mod.logits_fn(self.eval_student()),
            img_size=self.img_size, stats=self.dataset_stats,
            valid_indices=valid_indices, label_smoothing=ls,
        )
        acc = None
        for images, labels in self.device_batches(
                source, split, seed=0, shuffle=False, drop_last=False,
                limit=cfg.data.get("limit_eval_batches")):
            acc = metrics_mod.accumulate(acc, step(images, labels))
        return metrics_mod.finalize(acc)

    def train(self, source, start_epoch: int = 0) -> dict[str, list]:
        cfg = self.config
        self.source = source
        num_epochs = cfg.training.num_epochs
        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            train_metrics = self.train_epoch(source, epoch)
            val_metrics = self.evaluate(source)
            dt = time.perf_counter() - t0
            losses = " ".join(f"{v:.6f}" for v in train_metrics["step_losses"])
            print(
                f"epoch {epoch + 1}/{num_epochs} "
                f"train_loss={train_metrics['train_loss']:.6f} "
                f"train_acc={train_metrics['train_acc']:.4f} "
                f"val_acc={val_metrics['val_acc']:.4f} "
                f"epoch_time={dt:.1f}s step_losses=[{losses}]"
            )
            for k, v in {**train_metrics, **val_metrics}.items():
                self.metrics_history[k].append(v)
            self._mlog.log("epoch", epoch=epoch + 1, epoch_time_s=round(dt, 2),
                           **train_metrics, **val_metrics)
            if val_metrics["val_acc"] > self.best_val_acc:
                self.best_val_acc = val_metrics["val_acc"]
                self.save_checkpoint("best_model", epoch)
                self.save_weights("best_model_weights", epoch)
            self.save_checkpoint("latest", epoch)
        self.save_weights("final_model_weights", num_epochs - 1)
        print(f"training complete best_val_acc={self.best_val_acc:.4f}")
        return dict(self.metrics_history)

    # -------------------------------------------------------- checkpoints

    def _ckpt_dir(self) -> Path:
        cfg = self.config
        return Path(cfg.run.output_dir) / cfg.run.name / "checkpoints"

    def save_checkpoint(self, name: str, epoch: int) -> None:
        st = self.opt_state
        state = {
            "x": st.x, "z": st.z, "v": st.v,
            "scalars": {"k": st.k, "lr_max": st.lr_max,
                        "weight_sum": st.weight_sum},
            "sel_buffers": self.sel_buffers,
            "rng": self.generator.get_state(),
        }
        ckpt.save_state(self._ckpt_dir() / name, state, {
            "epoch": epoch,
            "best_val_acc": self.best_val_acc,
            "metrics_history": dict(self.metrics_history),
        })

    def save_weights(self, name: str, epoch: int) -> None:
        params = {k[len(_STUDENT):]: v
                  for k, v in sf.eval_params(self.opt_state).items()
                  if k.startswith(_STUDENT)}
        ckpt.save_weights(self._ckpt_dir() / name, params, epoch)

    def load_checkpoint(self, path: str) -> int:
        state, custom = ckpt.load_state(path, map_location=self.device)
        self.opt_state = sf.ScheduleFreeState(
            x=state["x"], z=state["z"], v=state["v"], **state["scalars"]
        )
        self.sel_buffers = state["sel_buffers"]
        self.generator.set_state(state["rng"].cpu())
        self.best_val_acc = custom["best_val_acc"]
        self.metrics_history = defaultdict(list, custom["metrics_history"])
        return custom["epoch"] + 1

    @property
    def eval_student_params(self) -> dict:
        return {k[len(_STUDENT):]: v
                for k, v in sf.eval_params(self.opt_state).items()
                if k.startswith(_STUDENT)}
