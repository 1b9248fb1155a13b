"""K8 converged (``csrc/converged_eigh.cu``, counter ``K8 converged``): the
'xla' eigh on the card for float32 matrices of n <= 512, one launch a call
with its sort. A matrix counts ``counts.eigh_flops(n)`` operations at the
float32 peak (the stated 9 n^3 of an eigh with its vectors, whatever the
sweeps), with A read and V and w written once. The selector's batches
follow from the shapes: the stacked teacher and student Grams (L_t + P,
D_s, D_s) under 'gram' and 'jacobi', and under 'gram' the principal
angles' (P L_t, r, r); 'jacobi' takes its angles through K8."""

from portbench import counts

# the widest matrix the route takes; wider ones go to torch.linalg.eigh
MAX_N = 512


def launch_seconds(batch: int, n: int) -> float:
    moved = counts.F32 * batch * (2 * n * n + n)
    return counts.least_seconds(moved, batch * counts.eigh_flops(n),
                                counts.PEAK_F32)


def rows(s: counts.StepShape) -> dict:
    t, st = s.teacher, s.student
    batches = []
    if s.backend in ("gram", "jacobi"):
        batches.append((t.depth + s.points, st.dim))
    if s.backend == "gram":
        batches.append((s.points * t.depth, s.rank_cap))
    found = [(launch_seconds(b, n), 1) for b, n in batches if n <= MAX_N]
    return {"K8 converged": found} if found else {}
