#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``basd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile [--profile-out FILE]]

Phases, each closed by ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without printing a result:

1. device: the card's name and power limit (nvidia-smi), full-f32 matmul
   and convolution precision, and the build of every CUDA kernel from
   ``basd_tpu_torch/csrc``;
2. kernels: each hand-written kernel of the train step (K1, K2, K6 forward
   and dw, K7) against its plain PyTorch version on the same inputs on the
   card, at the shapes the train step gives it (B=128), within the
   tolerances of the CPU tests; both timed with CUDA events (median of
   several runs);
3. train: ``basd_tpu_torch.train.main`` for 3 steps of B=128 at 224 px,
   DeiT-Small teacher, DeiT-Tiny preset student sized by calibration, on
   synthetic ImageNet-100; every kernel's launch counter must be > 0 after
   it, and the step losses finite;
4. check and timing: the kernel teacher forward against the plain one (on
   the CPU) at full width on a small batch, then per-stage CUDA-event times
   of further train steps;
5. with ``--profile`` only: ``torch.profiler`` over 3 more steps, for the
   device-busy share, device activities per step and the top device ops.

The last two lines of standard output are the kernels' JSON and the
contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 128
TRAIN_ARGS = [
    "data.dataset=synthetic/imagenet100", "data.source=synthetic",
    "data.eval_datasets=[]", f"data.batch_size={BATCH}",
    "model.vit.img_size=224", "model.vit.patch_size=16",
    "basd.teacher_model_name=deit_small_patch16_224",
    "training.num_epochs=1", "+data.limit_train_batches=3",
    "+data.limit_eval_batches=1",
]
# the tracer's own buffer activity, which the profiler lists as device time
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(torch, fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def kernel_phase(torch, device):
    """Each kernel against its plain version at the step's shapes."""
    from basd_tpu_torch.kernels import block_attn, block_mlp, mix_stack, ns_polar

    g = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    b, n, d, h, f, num_l, num_p = BATCH, 197, 384, 6, 1536, 12, 4
    x = rn(b, n, d).to(bf)
    ln_s, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    w_qkv, b_qkv = rn(3 * d, d, scale=d ** -0.5).to(bf), 0.1 * rn(3 * d)
    w_proj, b_proj = rn(d, d, scale=d ** -0.5).to(bf), 0.1 * rn(d)
    w1, b1 = rn(f, d, scale=d ** -0.5).to(bf), 0.1 * rn(f)
    w2, b2 = rn(d, f, scale=f ** -0.5).to(bf), 0.1 * rn(d)
    ones = torch.ones(b, device=device)
    results = {}

    # K1
    args1 = (x, ln_s, ln_b, w_qkv, b_qkv, w_proj, b_proj, h)
    out, imp = block_attn.fused_block_attn(*args1)
    ref, ref_imp = block_attn.block_attn_plain(*args1)
    err = (out.float() - ref.float()).abs().max().item()
    imp_err = (imp - ref_imp).abs().max().item()
    check(err <= 2 ** -5 * max(ref.float().abs().max().item(), 1.0), f"K1 out err {err}")
    check(imp_err <= 2e-2 * ref_imp.max().item(), f"K1 importance err {imp_err}")
    results["K1 fused_block_attn"] = (
        err, time_ms(torch, lambda: block_attn.fused_block_attn(*args1)),
        time_ms(torch, lambda: block_attn.block_attn_plain(*args1)))

    # K2
    m_rows = b * n
    buf = torch.full((num_l * m_rows, d), 3.0, dtype=bf, device=device)
    args2 = (x, ones, ln_s, ln_b, w1, b1, w2, b2)
    out = block_mlp.fused_ln_mlp_collect(*args2, buf, 5)
    ref = block_mlp.block_mlp_plain(*args2)
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 2 ** -5 * max(ref.float().abs().max().item(), 1.0), f"K2 out err {err}")
    check(torch.equal(buf[5 * m_rows:6 * m_rows], out.reshape(m_rows, d)),
          "K2 collect slab differs from out")
    check(bool((buf[:5 * m_rows] == 3.0).all() and (buf[6 * m_rows:] == 3.0).all()),
          "K2 wrote outside its slab")
    results["K2 fused_ln_mlp_collect"] = (
        err, time_ms(torch, lambda: block_mlp.fused_ln_mlp_collect(*args2, buf, 5)),
        time_ms(torch, lambda: block_mlp.block_mlp_plain(*args2)))

    # K6 forward and dw, bf16 stack (L, B*N, D)
    t = rn(num_l, m_rows, d).to(bf)
    w = torch.softmax(rn(num_p, num_l), -1).to(bf)
    out = mix_stack.mix_stack_fwd(w, t)
    ref = mix_stack.mix_fwd_plain(w, t)
    err = (out.float() - ref.float()).abs().max().item()
    check(bool(((out.float() - ref.float()).abs()
                <= 2e-2 + 2e-2 * ref.float().abs()).all()), f"K6 fwd err {err}")
    results["K6a mix_stack fwd"] = (
        err, time_ms(torch, lambda: mix_stack.mix_stack_fwd(w, t)),
        time_ms(torch, lambda: mix_stack.mix_fwd_plain(w, t)))
    cot = rn(num_p, m_rows, d).to(bf)
    dw = mix_stack.mix_stack_dw(cot, t)
    ref = mix_stack.mix_dw_plain(cot, t)
    err = (dw - ref).abs().max().item()
    check(err <= 5e-3 * ref.abs().max().item(), f"K6 dw err {err}")
    results["K6b mix_stack dw"] = (
        err, time_ms(torch, lambda: mix_stack.mix_stack_dw(cot, t)),
        time_ms(torch, lambda: mix_stack.mix_dw_plain(cot, t)))

    # K7 on a decaying-spectrum batch (condition 1e2) at (P*B, 192, 384)
    nb, r, c = num_p * b, 192, 384
    u = torch.linalg.qr(rn(nb, r, r))[0]
    v = torch.linalg.qr(rn(nb, c, c))[0][:, :, :r]
    s = torch.logspace(0, -2, r, device=device)
    mats = torch.einsum("bik,k,bjk->bij", u, s, v).contiguous()
    out = ns_polar.ns_polar_hybrid(mats)
    ref = ns_polar.ns_polar_plain(mats)
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 3e-2, f"K7 err {err}")
    p = out.double()
    defect = (p @ p.transpose(-1, -2) - torch.eye(r, device=device,
                                                 dtype=torch.float64)).abs().max().item()
    check(defect <= 5e-2, f"K7 polar defect {defect}")
    results["K7 ns_polar_hybrid"] = (
        err, time_ms(torch, lambda: ns_polar.ns_polar_hybrid(mats)),
        time_ms(torch, lambda: ns_polar.ns_polar_plain(mats)))

    for name, (err, ms, plain_ms) in results.items():
        print(f"kernel {name}: max_abs_err={err} ms={ms} plain_ms={plain_ms}")
    return results


def teacher_check(torch, trainer, device):
    """The kernel teacher forward (K1/K2 on the card) against the plain
    chain on the CPU, same weights, full width, small batch."""
    import copy
    import dataclasses

    from basd_tpu_torch.models.registry import teacher_extract

    teacher = trainer.teacher
    cpu_teacher = dataclasses.replace(
        teacher, module=copy.deepcopy(teacher.module).cpu())
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 224, 224, 3), generator=g).to(torch.bfloat16)
    tok_k, imp_k = teacher_extract(teacher, x.to(device))
    tok_p, imp_p = teacher_extract(cpu_teacher, x)
    a, b_ = tok_k.to_dense().float().cpu(), tok_p.to_dense().float()
    err = (a - b_).abs().max().item()
    scale = b_.abs().max().item()
    imp_err = (imp_k.cpu() - imp_p).abs().max().item()
    print(f"teacher kernels vs plain: tokens max_abs_err={err} (scale {scale}) "
          f"importance max_abs_err={imp_err}")
    check(math.isfinite(err) and err <= 2 ** -5 * max(scale, 1.0),
          f"teacher tokens err {err}")
    check(imp_err <= 2e-2 * imp_p.max().item(), f"teacher importance err {imp_err}")


def train_batches(trainer, count: int, seed: int) -> list:
    """``count`` further train batches of the run's source, on the card."""
    return list(trainer.device_batches(trainer.source, "train", seed=seed,
                                       shuffle=True, drop_last=True,
                                       limit=count))


def stage_times(torch, trainer, steps: int = 5) -> dict:
    """CUDA-event time of each stage of further train steps, B=128."""
    from basd_tpu_torch.training import schedulefree as sf

    cfg = trainer.config
    data = train_batches(trainer, steps + 1, seed=7)
    names = ("views", "teacher", "student_loss_grads", "update")
    per = {k: [] for k in names}
    total = []
    torch.cuda.reset_peak_memory_stats()
    for i, (images, labels) in enumerate(data):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        with torch.no_grad():
            views = trainer.make_views(images, labels)
        ev[1].record()
        t_tokens, t_imp = trainer.teacher_forward(views.clean)
        ev[2].record()
        _, _, _, grads, y = trainer.loss_and_grads(views, t_tokens, t_imp)
        ev[3].record()
        sf.update(trainer.opt_state, grads, trainer.sf_cfg, y=y)
        ev[4].record()
        torch.cuda.synchronize()
        if i == 0:
            continue  # warm-up
        for k, (a, b_) in zip(names, zip(ev[:-1], ev[1:])):
            per[k].append(a.elapsed_time(b_))
        total.append(ev[0].elapsed_time(ev[4]))
    out = {k: statistics.median(v) for k, v in per.items()}
    out["step"] = statistics.median(total)
    out["img_per_s"] = cfg.data.batch_size / (out["step"] / 1000.0)
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def profile_steps(torch, trainer, out_path, steps: int = 3) -> dict:
    """``torch.profiler`` over ``steps`` train steps after two warm-ups.

    Returns the wall time per step, the device-busy share (union of the
    card's kernel and copy intervals over the wall time, so overlapping
    activity counts once) and the device activities per step; prints the
    ops with the most device time and, with ``out_path``, writes the full
    tables there. Profiling slows the host, so the busy share it reads is
    a lower bound for an unprofiled step.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data = train_batches(trainer, steps + 2, seed=11)
    for images, labels in data[:2]:
        trainer.step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for images, labels in data[2:]:
            trainer.step(images, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in PROFILER_OVERHEAD)
    busy_us, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    averages = prof.key_averages()
    top = sorted((a for a in averages if a.key not in PROFILER_OVERHEAD),
                 key=lambda a: -a.self_device_time_total)[:12]
    for a in top:
        print(f"profile op {a.key[:60]!r}: self_device_ms_per_step="
              f"{a.self_device_time_total / 1e3 / steps} calls_per_step="
              f"{a.count / steps}")
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(
            averages.table(sort_by="self_device_time_total", row_limit=60,
                           max_name_column_width=80)
            + "\n" + averages.table(sort_by="device_time_total",
                                    row_limit=40, max_name_column_width=80))
    return {"profiled_step_ms": wall_us / 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / wall_us,
            "device_activities_per_step": len(spans) / steps}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler phase: device-busy share, "
                             "device activities and top ops per step")
    parser.add_argument("--profile-out", default=None,
                        help="file for the profiler's full op tables")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "basd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    phase("device")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    from basd_tpu_torch import kernels
    from basd_tpu_torch.kernels import _build
    from basd_tpu_torch.ops.linalg import set_full_f32_precision

    set_full_f32_precision()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()

    phase("kernels")
    results = kernel_phase(torch, device)
    torch.cuda.synchronize()

    phase("train")
    from basd_tpu_torch import train

    with tempfile.TemporaryDirectory() as out_dir:
        kernels.reset_launch_counts()
        trainer = train.main(TRAIN_ARGS + [f"run.output_dir={out_dir}"],
                             device=device)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        metrics = Path(out_dir) / trainer.config.run.name / "metrics.jsonl"
        records = [json.loads(line) for line in metrics.read_text().splitlines()]
    print(f"launches {counts}")
    for name, count in counts.items():
        check(count > 0, f"{name} never launched on the main path")
    check(counts["K1 fused_block_attn"] % 12 == 0
          and counts["K2 fused_ln_mlp_collect"] % 12 == 0,
          "K1/K2 must run 12 times per teacher forward")
    losses = [r["loss"] for r in records if r["kind"] == "step"]
    print(f"step losses {losses}")
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses),
          f"expected 3 finite step losses, got {losses}")

    phase("check and timing")
    teacher_check(torch, trainer, device)
    times = stage_times(torch, trainer)
    torch.cuda.synchronize()
    print("step_ms " + json.dumps(times))
    if args.profile:
        phase("profile")
        prof = profile_steps(torch, trainer, args.profile_out)
        torch.cuda.synchronize()
        print("profile " + json.dumps(prof))

    entries = []
    for name, route, source, replaces, _fn in kernels.KERNELS:
        err, ms, plain_ms = results[name]
        entries.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
