"""K9 and the TrivialAugmentWide stage around it, timed on one tree's port.

    python3 scripts/k9_compare.py [ROOT] [--sweep]

On one CUDA GPU, with ROOT's ``basd_tpu_torch`` (default: this checkout;
e.g. a parent unpacked with ``git archive``) and this checkout's
``chip_smoke`` and ``basd_tpu_torch/tune.py`` timers (``time_cold_ms``:
L2 flushed before each call; ``_device_ms``: a CUDA graph of 20 calls
replayed, device time with the inputs in L2; ``time_ms``: back to back
through the host, dispatch included), on 224 px
RandomResizedCrop views of a synthetic canvas, B=128, generator seeded 0:

- K9 alone at the train step's geometric slice (46, 224, 224, 3) uint8,
  big rotations among its images (``chip_smoke.geo_slice``), and at the
  whole view batch (128, 224, 224, 3), ops 1-5 drawn per image; a tree
  whose ``geom_shift3`` takes no ``big`` gets the images flipped first, as
  its ``geom_three_pass`` gives them;
- ``geom_three_pass`` (tables, flip, K9) on the geometric slice;
- ``trivial_augment_wide_stratified`` on the 128 views (all 14 ops), with
  the K9 launches it makes (not graph-timed: it copies tables from the
  host);

each K9 output held bit for bit to the tree's plain version. With
``--sweep`` (a tree whose ``geom_shift3`` takes ``split`` and
``variant``): K9 at both shapes, and on the geometric slice with every
shift 0, for 1, 2, 3, 4 and 8 CTAs an image, each CTA holding the whole
image or reading the source from device memory.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", nargs="?", default=str(HERE))
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("k9_compare: no CUDA device", file=sys.stderr)
        return 1
    cs = _load("chip_smoke_timers", HERE / "chip_smoke.py")
    tune = _load("tune_timers", HERE / "basd_tpu_torch" / "tune.py")
    from basd_tpu_torch.data import augment as aug
    from basd_tpu_torch.kernels import geom_shift

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b = 128
    canvas = torch.randint(0, 256, (b, 256, 256, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    draws = aug.draw_train_views(g, b, dev)
    boxes = aug.rrc_boxes(draws.u_area, draws.logr, draws.u_ij, 256, 256)
    views = aug._q(aug.random_resized_crop(canvas, boxes, draws.flip,
                                           224)).contiguous()
    takes_big = "big" in inspect.signature(geom_shift.geom_shift3).parameters
    tag = f"{root.name} ({'CUDA, flip folded' if takes_big else 'flip outside'})"

    def times(fn, graph=True):
        return {"cold_ms": cs.time_cold_ms(torch, fn),
                "graph_ms": tune._device_ms(torch, fn) if graph else None,
                "back_to_back_ms": cs.time_ms(torch, fn)}

    def row(what, fn, graph=True, **extra):
        print(json.dumps({"tree": tag, "what": what, **times(fn, graph),
                          **extra}), flush=True)

    def k9_call(x, op, mag, **kw):
        big, r1, r2, r3 = aug.geom_shifts(op, mag, x.shape[1], x.shape[2])
        if takes_big:
            fn = lambda: geom_shift.geom_shift3(x, r1, r2, r3, big, **kw)  # noqa: E731
            ref = geom_shift.geom_shift3_plain(x, r1, r2, r3, big)
        else:
            xf = torch.where(big[:, None, None, None], x.flip(1, 2), x)
            fn = lambda: geom_shift.geom_shift3(xf, r1, r2, r3)  # noqa: E731
            ref = geom_shift.geom_shift3_plain(xf, r1, r2, r3)
        cs.check(torch.equal(fn(), ref), f"{tag}: K9 differs from its plain version")
        return fn

    xg, op_g, mag_g = cs.geo_slice(torch, aug, views, draws)
    op_b = torch.randint(1, 6, (b,), generator=g, device=dev)
    mags = torch.as_tensor(aug.TAW_MAGS, device=dev)[op_b, draws.mag_idx]
    mag_b = mags * torch.where(draws.sign, -1.0, 1.0)
    shapes = (("geometric slice", xg, op_g, mag_g), ("whole batch", views, op_b, mag_b))
    for what, x, op, mag in shapes:
        row(f"K9 {what} {tuple(x.shape)}", k9_call(x, op, mag))
    row(f"geom_three_pass {tuple(xg.shape)}",
        lambda: aug.geom_three_pass(xg, op_g, mag_g))
    before = geom_shift.geom_shift3.launches
    aug.trivial_augment_wide_stratified(views, draws.perm, draws.mag_idx, draws.sign)
    row(f"trivial_augment_wide_stratified {tuple(views.shape)}",
        lambda: aug.trivial_augment_wide_stratified(views, draws.perm,
                                                    draws.mag_idx, draws.sign),
        graph=False, k9_launches=geom_shift.geom_shift3.launches - before)
    if args.sweep:
        # every shift 0 (a translation by 0): no pass moves a pixel
        shapes += (("zero shifts", xg, torch.full_like(op_g, 3),
                    torch.zeros_like(mag_g)),)
        for what, x, op, mag in shapes:
            for split in (1, 2, 3, 4, 8):
                for variant in ("smem", "global"):
                    fn = k9_call(x, op, mag, split=split, variant=variant)
                    print(json.dumps({
                        "tree": tag, "what": f"K9 sweep {what} {tuple(x.shape)}",
                        "split": split, "variant": variant, **times(fn)}),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
