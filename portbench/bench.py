"""One run of one cell: build the port's BASD trainer from the benchmark's
inputs, drive its first three steps (the warm-up, and what the check
compares), time whole ``Trainer.step`` calls for ``--seconds``, read the
trace in a traced run, then free the program, run the reference and
judge. The program is ``basd_tpu_torch``; nothing here imports the JAX
package."""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time

import torch

from portbench import check, counts
from portbench.cells import BENCH_DIR, Cell
from portbench.inputs import make_inputs
from portbench.reference.step import reference_steps
from portbench.trace import Trace

SETUP_STEPS = 3
PROFILED_STEPS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "basd_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def program_config(cell: Cell, run_seed: int, out_dir: str):
    """The port's config for the cell's trainer, every key it reads set
    from the configuration file."""
    from basd_tpu_torch.config import ConfigNode

    c = cell.config
    return ConfigNode({
        "run": {"seed": run_seed, "output_dir": out_dir, "name": cell.name},
        "model": {"vit": {"img_size": c["img_size"],
                          "patch_size": c["student"]["patch_size"]},
                  "num_classes": c["num_classes"]},
        "basd": dict(c["basd"]),
        "training": {"label_smoothing": c["label_smoothing"],
                     **c["training"]},
        "tpu": dict(c["tpu"]),
    })


def arch(m: dict) -> dict:
    """A ViT's widths as the port's ``create_model`` takes them: over a
    preset's, or whole for a model of no preset (the CPU tests'). The MLP's
    kind and hidden width go in where the configuration states them."""
    out = {k: m[k] for k in ("embed_dim", "depth", "num_heads", "mlp_ratio")}
    out.update({k: m[k] for k in ("mlp", "mlp_hidden") if k in m})
    if m.get("custom"):
        out.update(patch_size=m["patch_size"],
                   layerscale_init=1.0 if m.get("layerscale") else None)
    return out


def build_trainer(cell: Cell, inp: dict, device, out_dir: str):
    """The port's teacher, student and ``Trainer``, holding the benchmark's
    weights, projections and log-temperatures."""
    from basd_tpu_torch.models import create_model
    from basd_tpu_torch.ops.linalg import set_full_f32_precision
    from basd_tpu_torch.training.trainer import Trainer

    set_full_f32_precision()
    c = cell.config
    dtype = getattr(torch, c["precision"]["compute"])
    t, s, tpu = c["teacher"], c["student"], c["tpu"]
    teacher = create_model(
        t["preset"], img_size=c["img_size"], num_classes=0,
        arch_overrides=arch(t), importance_mode="cls", collect=True,
        dtype=dtype, attention_impl=tpu["teacher_attention_impl"])
    teacher.module.to(device).eval().requires_grad_(False)
    teacher.module.load_state_dict(inp["teacher"], strict=True)
    student = create_model(
        s["preset"], img_size=c["img_size"], num_classes=c["num_classes"],
        drop_path_rate=s["drop_path_rate"], arch_overrides=arch(s),
        importance_mode=None, remat=tpu["remat"],
        remat_policy=tpu["remat_policy"], dtype=dtype,
        attention_impl=tpu["student_attention_impl"],
        mlp_impl=tpu["student_mlp_impl"])
    student.module.to(device)
    student.module.load_state_dict(inp["student"], strict=True)
    stats = c["stats"]
    trainer = Trainer(program_config(cell, inp["run_seed"], out_dir),
                      student_bundle=student, teacher_bundle=teacher,
                      device=device, dataset_stats=stats["train"],
                      teacher_stats=stats["teacher"])
    trainer.sel_buffers = dict(inp["selector"])
    st = trainer.opt_state
    for tensors in (st.x, st.z):
        tensors["basd.log_temperatures"] = inp["log_temperatures"].clone()
    return trainer


def first_steps(trainer, inp: dict, pool: int) -> dict:
    """The program's first steps through ``Trainer.step``, on the pool's
    first batches: each step's loss, each leaf's first gradient norm from
    the second moment after one step, and each leaf's change to the point
    the next step evaluates at."""
    from basd_tpu_torch.training import schedulefree as sf

    st = trainer.opt_state
    x0 = {k: v.clone() for k, v in st.x.items()}
    losses, grad_norms = [], None
    for i in range(SETUP_STEPS):
        m = trainer.step(inp["images"][i % pool], inp["labels"][i % pool])
        losses.append(m["loss_sum"] / m["count"])
        if i == 0:
            b2 = trainer.sf_cfg.b2
            grad_norms = {k: torch.sqrt(v.double().sum() / (1.0 - b2))
                          for k, v in st.v.items()}
    y = sf.train_params(st, trainer.sf_cfg)
    return {"losses": [float(v) for v in losses],
            "grad_norms": {k: float(v) for k, v in grad_norms.items()},
            "changes": {k: (y[k] - x0[k]).float().cpu() for k in y}}


def timed_window(trainer, inp: dict, pool: int, seconds: float,
                 start_index: int) -> dict:
    """Whole steps until ``seconds`` have passed, then a synchronize: the
    steps, the host wall time and the device's, and each step's loss (read
    after the window)."""
    cuda = torch.cuda.is_available() and trainer.device.type == "cuda"
    if cuda:
        begin, finish = (torch.cuda.Event(enable_timing=True)
                         for _ in range(2))
        torch.cuda.synchronize()
        begin.record()
    t0 = time.perf_counter()
    sums, n = [], 0
    while True:
        i = (start_index + n) % pool
        m = trainer.step(inp["images"][i], inp["labels"][i])
        sums.append(m["loss_sum"])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        finish.record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(sums).float().cpu()
    return {"steps": n, "wall_s": wall,
            "event_s": begin.elapsed_time(finish) / 1e3 if cuda else wall,
            "failed": int((~torch.isfinite(losses)).sum())}


def profiled_window(trainer, inp: dict, pool: int, start_index: int) -> dict:
    """``PROFILED_STEPS`` steps under ``torch.profiler`` (CPU and CUDA
    activity): the trace, the host wall time and the launches each
    hand-written kernel's counter saw."""
    from torch.profiler import ProfilerActivity, profile

    from basd_tpu_torch import kernels

    before = kernels.launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for n in range(PROFILED_STEPS):
            i = (start_index + n) % pool
            trainer.step(inp["images"][i], inp["labels"][i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    trace = Trace.from_profile(prof)
    after = kernels.launch_counts()
    log(f"trace read in {time.perf_counter() - t1:.1f} s: "
        f"{len(trace.device)} device and {len(trace.ops)} host events")
    return {"trace": trace, "wall_s": wall, "steps": PROFILED_STEPS,
            "launches": {k: after[k] - before.get(k, 0) for k in after}}


def read_metrics(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell from its reader
    (``portbench/metrics/<name>.py``); a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(prof: dict) -> dict:
    tr, k = prof["trace"], prof["steps"]
    ops = sorted(tr.by_kernel().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, ns / 1e9 / k] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in tr.idle_gaps(10)]}


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def card_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run(cell: Cell, seed: int, seconds: float, trace: bool, start: float,
        device="cuda", prepare=None) -> dict:
    """One run; returns the result line's object. ``prepare(trainer)``
    may replace parts of the trainer before its first step (the fault
    tests)."""
    import tempfile

    device = torch.device(device)
    on_card = device.type == "cuda"
    pool = int(cell.traffic["pool"])
    if pool <= SETUP_STEPS:
        raise ValueError("the pool must hold more batches than the first "
                         "steps take, so that they are rows that all differ")
    inp = make_inputs(cell.config, cell.traffic, seed, device)
    with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
        trainer = build_trainer(cell, inp, device, out_dir)
        if prepare is not None:
            prepare(trainer)
        prog = first_steps(trainer, inp, pool)
        log(f"program first steps: losses {prog['losses']}")
        setup_peak = 0
        if on_card:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - start
        metrics, extra = {}, {}
        if trace:
            from basd_tpu_torch.utils import trace as tracer

            tracer.reset()
            tracer.enable()
            try:
                win = timed_window(trainer, inp, pool, seconds, SETUP_STEPS)
                program = tracer.summary()
                log("program per step "
                    + json.dumps(tracer.per_step(program)))
                # on through the profile, so its spans annotate the trace
                prof = profiled_window(trainer, inp, pool,
                                       SETUP_STEPS + win["steps"])
            finally:
                tracer.disable()
        else:
            win = timed_window(trainer, inp, pool, seconds, SETUP_STEPS)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if trace:
            shape = counts.step_shape(cell.config, cell.traffic)
            busy_ns, _ = prof["trace"].busy()
            ctx = {"program": program, "steps": win["steps"],
                   "event_s": win["event_s"], "profile": prof,
                   "busy_ms": busy_ns / 1e6 / prof["steps"], "shape": shape,
                   "counts": counts, "bench_dir": BENCH_DIR, "log": log}
            metrics = read_metrics(cell, ctx)
            extra = {"busy_s": busy_ns / 1e9, "window_s": prof["wall_s"]}
        else:
            b = cell.traffic["batch"]
            values = {"train_img_per_s": ("img/s", b * win["steps"]
                                          / win["wall_s"]),
                      "peak_mem_gib": ("GiB", peak / 2 ** 30),
                      "setup_s": ("s", setup_s)}
            metrics = {m["name"]: {"value": values[m["name"]][1],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in values}
        log(f"window: {win['steps']} steps in {win['wall_s']:.3f} s (host), "
            f"{win['event_s']:.3f} s (events); setup {setup_s:.2f} s")
        result = {
            "correct": False, "attempted": win["steps"],
            "failed": win["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if on_card else device.type,
                       "kind": (torch.cuda.get_device_name(device)
                                if on_card else "cpu"),
                       "count": cell.chips,
                       "memory_peak_bytes": max(peak, setup_peak),
                       **extra},
        }
        if trace:
            result["breakdown"] = breakdown(prof)
            del prof, ctx
        del trainer, inp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or the JAX package loaded: {found}")
    t_ref = time.perf_counter()
    ref = reference_steps(cell.config, cell.traffic, seed, device,
                          log=log)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s; program losses "
        f"{prog['losses']} reference {ref['losses']}; reference ranks "
        f"step 1 {ref['ranks'][0]}")
    numbers = check.readings(prog, ref)
    log(f"worst leaves: gradient {numbers['grad_leaf']}, change "
        f"{numbers['change_leaf']}; left out of the change: leaves "
        f"{numbers['left_out']}, {numbers['idle_elements']} elements")
    correct, checks = check.judge(numbers, cell.limits)
    result["correct"] = bool(correct and win["failed"] == 0)
    result["checks"] = checks
    if on_card:
        log(f"card: {card_limit()}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return result

