"""Eval suite (counterpart of ``basd_tpu/evaluation/metrics.py``).

- ``make_eval_step``, ``accumulate``, ``finalize``: the eval step shared
  with the trainer's validation, summed on the device, one host transfer
  per dataset;
- ``evaluate_model``: top-1 / top-5 micro accuracy and CE over a source's
  eval split, with ``valid_indices`` logit slicing for class-subset
  robustness datasets (reference ``metrics.py:106-136``);
- ``measure_efficiency``: parameter count, GFLOPs of one image's forward,
  steady-state throughput (``metrics.py:139-220``);
- ``run_eval_suite``: the primary dataset, the class-remapped robustness
  datasets and efficiency, one dict (``metrics.py:223-292``);
- ``save_metrics`` -> ``metrics.json`` (``metrics.py:295-300``), with the
  reference's keys.

With a model group (``tp``, a sharded student) every rank of the group runs
the suite together on the sharded forward; parameters and FLOPs are the
whole model's (a gathered CPU copy, ``models.vit.whole_vit``) and only its
rank 0 prints.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from basd_tpu_torch.data import augment as aug
from basd_tpu_torch.data.pipeline import prefetch
from basd_tpu_torch.data.sources import (
    source_from_config,
    stats_from_config,
    subset_indices_from_names,
)
from basd_tpu_torch.models.vit import whole_vit


def make_eval_step(apply_logits_fn: Callable, *, img_size: int, stats: tuple,
                   valid_indices=None, label_smoothing: float = 0.0):
    """uint8 canvases + labels -> summed top1/top5/CE (one implementation
    for trainer validation and the eval suite). ``apply_logits_fn(x)``
    maps (B, S, S, 3) images to logits."""
    stats = tuple(map(tuple, stats))

    @torch.no_grad()
    def step(images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        x = aug.make_eval_view(images_u8, img_size, stats)
        logits = apply_logits_fn(x).float()
        if valid_indices is not None:
            logits = logits[:, torch.as_tensor(valid_indices,
                                               device=logits.device)]
        valid = labels >= 0
        num_c = logits.shape[-1]
        onehot = F.one_hot(labels.clamp(min=0).long(), num_c).float()
        if label_smoothing:
            onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_c
        ce = -(onehot * torch.log_softmax(logits, -1)).sum(-1)
        top5 = logits.topk(min(5, num_c), dim=-1).indices
        return {
            "ce_sum": torch.where(valid, ce, torch.zeros_like(ce)).sum(),
            "top1": ((logits.argmax(-1) == labels) & valid).sum(),
            "top5": ((top5 == labels[:, None]).any(-1) & valid).sum(),
            "count": valid.sum(),
        }

    return step


def accumulate(acc: dict | None, m: dict) -> dict:
    """Device-side running sums: no host transfer per batch."""
    if acc is None:
        return {k: v.clone() for k, v in m.items()}
    for k in acc:
        acc[k] += m[k]
    return acc


def finalize(acc: dict | None) -> dict[str, float]:
    """One host transfer for the whole accumulated dict."""
    if acc is None:
        return {"val_acc": 0.0, "val_acc_top5": 0.0, "loss": 0.0}
    host = {k: v.item() for k, v in acc.items()}
    total = max(int(host["count"]), 1)
    return {
        "val_acc": 100.0 * int(host["top1"]) / total,
        "val_acc_top5": 100.0 * int(host["top5"]) / total,
        "loss": float(host["ce_sum"]) / total,
    }


# the most warm-up forwards ``measure_efficiency`` runs (reference
# ``metrics.py:202``)
WARMUP_FORWARDS = 5


def evaluate_model(apply_logits_fn: Callable, source, *, device: torch.device,
                   img_size: int, batch_size: int, crop_ratio: float,
                   stats: tuple, valid_indices=None,
                   label_smoothing: float = 0.0) -> dict[str, float]:
    """``val_acc``, ``val_acc_top5`` (percent) and ``loss`` (mean CE) of
    ``apply_logits_fn`` over the eval split of ``source``, the batches
    resized to the eval-crop canvas and prefetched on a host thread."""
    step = make_eval_step(apply_logits_fn, img_size=img_size, stats=stats,
                          valid_indices=valid_indices,
                          label_smoothing=label_smoothing)
    r = round(img_size / crop_ratio)
    batches = source.load_batches("eval", batch_size, r, shuffle=False,
                                  seed=0, drop_last=False)
    acc = None
    for batch in prefetch(batches):
        acc = accumulate(acc, step(torch.from_numpy(batch["image"]).to(device),
                                   torch.from_numpy(batch["label"]).to(device)))
    return finalize(acc)


def logits_fn(model: torch.nn.Module) -> Callable:
    """(B, S, S, 3) images -> the model's logits, computed in bf16."""
    return lambda x: model(x.to(torch.bfloat16), deterministic=True)["logits"]


@torch.no_grad()
def measure_efficiency(model: torch.nn.Module, *, img_size: int,
                       in_channels: int = 3, batch_size: int = 64,
                       num_warmup: int = 50,
                       num_batches: int = 200, tp=None) -> dict[str, float]:
    """Parameter count, GFLOPs of one image's forward, and the throughput
    of ``num_batches`` bf16 forwards of ``batch_size`` images after
    ``min(num_warmup, WARMUP_FORWARDS)`` warm-up ones.

    On a CUDA device one forward is captured in a CUDA graph and the graph
    replayed ``num_batches`` times between two CUDA events, so the timed
    forwards run back to back on the card as the reference's chained
    on-device scan does (``basd_tpu/evaluation/metrics.py:171-211``), not
    at the host's dispatch rate. The kernel wrappers' launch counts see
    the warm-up forwards and the captured one, not the replays. On the CPU
    the forwards run one after another under ``time.perf_counter``.

    The FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of a
    forward of a CPU copy of the model, where every kernel wrapper runs its
    plain PyTorch version (the counter sees aten operators, not a kernel
    launched by hand). It counts 2 per multiply-add of the products and
    convolutions only; the reference's number is XLA's cost analysis of the
    compiled forward (``compiled.cost_analysis()['flops']``), which also
    counts elementwise work, so the two differ by that share.

    With ``tp`` (a rank of the model group over which ``model``'s blocks
    are sharded; every rank of it calls) the parameters and FLOPs are
    counted on the whole model, gathered into the CPU copy, and the timed
    forwards, whose sums over the group cannot be captured in a CUDA graph,
    run one after another between the two events."""
    device = next(model.parameters()).device
    cpu_model = (copy.deepcopy(model).cpu() if tp is None
                 else whole_vit(model, tp))
    param_count = sum(p.numel() for p in cpu_model.parameters())
    x1 = torch.zeros((1, img_size, img_size, in_channels), dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as counter:
        logits_fn(cpu_model)(x1)
    gflops = counter.get_total_flops() / 1e9
    del cpu_model

    forward = logits_fn(model)
    xb = torch.zeros((batch_size, img_size, img_size, in_channels),
                     dtype=torch.bfloat16, device=device)
    for _ in range(max(1, min(num_warmup, WARMUP_FORWARDS))):
        forward(xb)
    if device.type == "cuda":
        graph = None
        if tp is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                forward(xb)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(num_batches):
            if graph is None:
                forward(xb)
            else:
                graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        elapsed = start.elapsed_time(end) / 1e3
        del graph
    else:
        start_s = time.perf_counter()
        for _ in range(num_batches):
            forward(xb)
        elapsed = time.perf_counter() - start_s
    return {
        "param_count": param_count,
        "param_count_m": param_count / 1e6,
        "gflops": gflops,
        "throughput_img_per_sec": batch_size * num_batches / elapsed,
    }


def run_eval_suite(model: torch.nn.Module, config, *, config_path: str,
                   efficiency_batches: int = 200, tp=None) -> dict[str, Any]:
    """The primary dataset, each of ``data.eval_datasets`` (its classes
    remapped into the primary label space) and efficiency, for ``model``
    (the student holding its eval weights, on its device), each over its
    whole eval split; ``tp``: the model group ``model``'s blocks are
    sharded over (every rank of it calls)."""
    log = print if tp is None or tp.rank == 0 else (lambda *a, **k: None)
    device = next(model.parameters()).device
    datasets = [config.data.dataset] + list(config.data.eval_datasets)
    stats = stats_from_config(config)
    img_size = config.model.vit.img_size
    primary_source = source_from_config(config)
    primary_names = None  # fetched only to remap a robustness subset
    apply = logits_fn(model)

    primary: dict = {}
    robustness: dict = {}
    for name in datasets:
        if name == config.data.dataset:
            source, valid_indices = primary_source, None
        else:
            source = source_from_config(config, name)
            if primary_names is None:
                primary_names = primary_source.class_names()
            valid_indices = subset_indices_from_names(source.class_names(),
                                                      primary_names)
        metrics = evaluate_model(
            apply, source, device=device, img_size=img_size,
            batch_size=config.data.batch_size,
            crop_ratio=config.data.eval_crop_ratio, stats=stats,
            valid_indices=valid_indices,
        )
        if name == config.data.dataset:
            primary = metrics
        else:
            robustness[name] = metrics
        log(f"eval {name} top1={metrics['val_acc']:.4f} "
              f"top5={metrics['val_acc_top5']:.4f} loss={metrics['loss']:.6f}")

    efficiency = measure_efficiency(model, img_size=img_size,
                                    num_batches=efficiency_batches, tp=tp)
    log(f"efficiency params_m={efficiency['param_count_m']:.4f} "
          f"gflops={efficiency['gflops']:.4f} "
          f"throughput={efficiency['throughput_img_per_sec']:.2f} img/s")
    return {
        "run": {"name": config.run.name, "config": config_path},
        "primary": {"dataset": config.data.dataset, **primary},
        "robustness": robustness,
        "efficiency": efficiency,
    }


def save_metrics(results: dict[str, Any], output_dir) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / "metrics.json"
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path
