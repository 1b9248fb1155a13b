"""``portbench/control.py`` with the reference's largest loss products taken
in chunks of rows, for a cell whose control does not fit on the card.

    python3 scripts/portbench_control_chunked.py --workload <cell> \
        --seeds 11,12 --kinds program,control,half [--program-seeds 13]

takes control.py's arguments and prints what it prints. ``Arith.mm`` on an
(L, D, M) x (L, M, D) pair that needs no gradient, M over 4 x CHUNK, sums
the products of CHUNK-row slices: the operands are rounded element by
element as ``Arith.mm`` rounds them, and only the order of the f32 sums
over M differs. Under the control's TF32 rounding the whole product takes
two rounded copies of its operands (2 x 15 GiB for the DINOv2 ViT-g/14
stack at B=256), which do not fit beside that cell's reference on an
80 GB card. The float32 reference and the faults take the whole product
as control.py does."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import arith  # noqa: E402

CHUNK = 8192
_mm = arith.Arith.mm


def mm(self, a, b):
    if (self.kind != "f32" and a.dim() == 3 and b.dim() == 3
            and a.shape[-1] == b.shape[-2] and a.shape[-1] > 4 * CHUNK
            and not a.requires_grad and not b.requires_grad):
        out = _mm(self, a[..., :CHUNK], b[..., :CHUNK, :])
        for s in range(CHUNK, a.shape[-1], CHUNK):
            out += _mm(self, a[..., s:s + CHUNK], b[..., s:s + CHUNK, :])
        return out
    return _mm(self, a, b)


arith.Arith.mm = mm
from portbench import control  # noqa: E402

sys.exit(control.main())
