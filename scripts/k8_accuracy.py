"""K8's eigenvalue error at 6 sweeps over many principal-angle batches.

    python3 scripts/k8_accuracy.py [ROOT] [--batches N]

On one CUDA GPU: for N (48, 96, 96) principal-angle batches
(``chip_smoke.principal_angle_grams``, generator seeded 0), the largest
|w - w_eigh| of K8 (``jacobi_eigh``) and of its plain version against
float64 ``torch.linalg.eigvalsh``, and between the two; then the medians
and maxima. ROOT (default: this checkout) is the checkout whose
``basd_tpu_torch`` and ``chip_smoke.py`` are imported, so the same script
measures another tree (e.g. a parent unpacked with ``git archive``).
"""

from __future__ import annotations

import argparse
import importlib
import statistics
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--batches", type=int, default=12)
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("k8_accuracy: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from basd_tpu_torch.ops.linalg import JACOBI_SWEEPS, set_full_f32_precision

    je = importlib.import_module("basd_tpu_torch.kernels.jacobi_eigh")
    set_full_f32_precision()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i in range(args.batches):
        a = cs.principal_angle_grams(torch, dev, g, 48, 192, 96)
        w, _ = je.jacobi_eigh(a, JACOBI_SWEEPS)
        wp, _ = je.jacobi_eigh_plain(a, JACOBI_SWEEPS)
        wl = torch.linalg.eigvalsh(a.double())
        rows.append((cs.max_err(w, wl), cs.max_err(wp, wl), cs.max_err(w, wp)))
        print(f"{root.name} batch {i}: kernel-eigh {rows[-1][0]:.4e} "
              f"plain-eigh {rows[-1][1]:.4e} kernel-plain {rows[-1][2]:.4e}",
              flush=True)
    for k, name in enumerate(("kernel-eigh", "plain-eigh", "kernel-plain")):
        vals = [r[k] for r in rows]
        print(f"{root.name} {name}: median {statistics.median(vals):.4e} "
              f"max {max(vals):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
