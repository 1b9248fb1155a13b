"""The benchmark's yardstick: published peaks, the shapes of a cell, the
model FLOPs of one train step and each hand-written kernel's least time.

Everything here is computed from the configuration's and the traffic's
sizes alone, whatever implements them, so a later change to the program
cannot move it. The per-launch counts are those of the kernel checks that
the port's bring-up used (operations and bytes each kernel's function
needs, each input byte read once and each output byte written once); the
polar iteration's count is ``polar_flops``, its symmetric products counted
once a pair. ``kernel_launches`` merges in the rows of the modules
``counts/launches_*.py``: each defines ``rows(shape) -> {counter name:
[(least seconds of one launch, launches a step), ...]}``, so a kernel's
arithmetic arrives as a file of its own.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from pathlib import Path

# NVIDIA H100 SXM, published dense peaks at 700 W: bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12

BF16, F32 = 2, 4

# the polar iteration's schedule: 5 quintic and 2 cubic steps
POLAR_QUINTIC_STEPS = 5
POLAR_CUBIC_STEPS = 2
# the Jacobi eigensolver's sweeps on the principal-angle batch
JACOBI_SWEEPS = 6
# the stated operation count of a symmetric eigendecomposition of an n x n
# matrix with its eigenvectors, over n^3 (tridiagonal reduction 4/3,
# implicit QR accumulating the rotations ~6, back-transformation 2,
# rounded up); every eigh of the step keeps its vectors
EIGH_N3 = 9.0
# the MLP's products a row, in units of D F: GELU's fc1 (F, D) and fc2
# (D, F); SwiGLU's fc1 (2 F, D), packed [a | g], and fc2 (D, F)
MLP_PRODUCTS = {"gelu": 2, "swiglu": 3}


def least_seconds(nbytes: float, flops: float, peak: float) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over ``peak``, the larger."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


def mlp_of(m: dict) -> tuple:
    """A ViT entry's MLP: (kind, hidden width F). The kind is ``mlp``,
    'gelu' where the entry states none, or 'swiglu' (y = fc2(silu(a) * g)
    with [a | g] = fc1(x)); F is ``mlp_hidden`` where stated, else
    round(D ``mlp_ratio``). A SwiGLU entry states its F."""
    kind = m.get("mlp", "gelu")
    if kind not in MLP_PRODUCTS:
        raise ValueError(f"unknown MLP kind {kind!r}; known: "
                         f"{sorted(MLP_PRODUCTS)}")
    if "mlp_hidden" in m:
        return kind, int(m["mlp_hidden"])
    if kind != "gelu":
        raise ValueError(f"a {kind} MLP states its hidden width "
                         f"('mlp_hidden')")
    return kind, int(round(m["embed_dim"] * m["mlp_ratio"]))


@dataclass(frozen=True)
class ViTShape:
    dim: int
    depth: int
    heads: int
    hidden: int
    patch: int
    img: int
    mlp: str = "gelu"

    @property
    def patches(self) -> int:
        return (self.img // self.patch) ** 2

    @property
    def tokens(self) -> int:  # with the CLS token
        return self.patches + 1


@dataclass(frozen=True)
class StepShape:
    """The sizes of one BASD train step of a cell."""

    batch: int
    teacher: ViTShape
    student: ViTShape
    classes: int
    points: int  # extraction points P
    rank_cap: int  # the principal angles' r_cap
    backend: str  # the selector's spectral backend


def step_shape(config: dict, traffic: dict) -> StepShape:
    """The step's sizes from a configuration file and a traffic file."""
    img = int(config["img_size"])

    def vit(m: dict) -> ViTShape:
        kind, hidden = mlp_of(m)
        return ViTShape(int(m["embed_dim"]), int(m["depth"]),
                        int(m["num_heads"]), hidden, int(m["patch_size"]),
                        img, kind)

    student = vit(config["student"])
    cap = config["basd"].get("max_rank")
    return StepShape(
        batch=int(traffic["batch"]), teacher=vit(config["teacher"]),
        student=student, classes=int(config["num_classes"]),
        points=int(config["basd"]["num_extraction_points"]),
        rank_cap=min(int(cap), student.dim) if cap else student.dim,
        backend=config["basd"]["spectral_backend"])


def polar_flops(b: int, r: int, c: int) -> int:
    """The polar iteration on ``b`` (r, c) matrices: each quintic step
    X X^T and G G^T, both symmetric (r (r + 1) / 2 dot products each, of
    length c and r), and H X; each cubic step X X^T and G X; two operations
    a multiply-add."""
    gram_x = r * (r + 1) * c
    gram_g = r * (r + 1) * r
    prod_x = 2 * r * r * c
    return b * (POLAR_QUINTIC_STEPS * (gram_x + gram_g + prod_x)
                + POLAR_CUBIC_STEPS * (gram_x + prod_x))


def vit_block_flops(m: int, b: int, n: int, d: int, f: int,
                    mlp: str = "gelu") -> float:
    """One transformer block's forward products: qkv and proj (4 D^2 a
    row), the MLP (2 D F a row for GELU, 3 D F for SwiGLU), the scores and
    P.V (2 N^2 D an image); two operations a multiply-add."""
    return (2.0 * m * (4 * d * d + MLP_PRODUCTS[mlp] * d * f)
            + 4.0 * b * n * n * d)


def vit_forward_flops(v: ViTShape, b: int, classes: int = 0) -> float:
    """A ViT's forward: patch embedding, the blocks, the head."""
    embed = 2.0 * b * v.patches * 3 * v.patch * v.patch * v.dim
    blocks = v.depth * vit_block_flops(b * v.tokens, b, v.tokens, v.dim,
                                       v.hidden, v.mlp)
    return embed + blocks + 2.0 * b * v.dim * classes


def eigh_flops(n: int) -> float:
    return EIGH_N3 * n ** 3


def step_model_flops(s: StepShape) -> dict:
    """Model FLOPs of one train step by part, fixed by the shapes alone.

    teacher: the forward. student: forward and backward without
    recomputation (three forwards; the patch embedding twice, its input
    needs no gradient). loss: the selector's Grams (teacher no grad,
    student forward and backward) and their projections, the stacked eigh
    and the principal angles' eigh at the stated n^3 counts, the
    principal-angle products, the layer mix and its weight gradient, the
    token resampling where the teacher's patch count differs, the
    Procrustes cross-covariance with its two backward products, and the
    polar iteration."""
    t, st, b, p = s.teacher, s.student, s.batch, s.points
    layers = t.depth
    m_t, m_s = b * t.patches, b * st.patches
    m_flat = b * t.tokens  # the packed teacher stack, CLS rows included
    r = s.rank_cap
    d_s, d_t = st.dim, t.dim
    embed_s = 2.0 * b * st.patches * 3 * st.patch * st.patch * d_s
    student = 3.0 * vit_forward_flops(st, b, s.classes) - embed_s
    grams = (2.0 * layers * m_t * d_t * d_t
             + layers * 2.0 * (d_s * d_t * d_t + d_s * d_s * d_t)
             + 3.0 * p * (2.0 * m_s * d_s * d_s + 4.0 * d_s ** 3))
    eigh = (layers + p) * eigh_flops(d_s) + p * layers * eigh_flops(r)
    angles = 3.0 * p * layers * (2.0 * d_s * r * r + 2.0 * r ** 3)
    mix = 2.0 * 2.0 * p * layers * m_flat * d_t
    resample = 0.0
    if t.patches != st.patches:
        resample = 3.0 * 2.0 * p * b * d_t * t.patches * st.patches
    procrustes = 3.0 * 2.0 * p * b * st.patches * d_s * d_t
    polar = float(polar_flops(p * b, d_s, d_t))
    return {
        "teacher": vit_forward_flops(t, b),
        "student": student,
        "loss": grams + eigh + angles + mix + resample + procrustes + polar,
    }


def total_model_flops(s: StepShape) -> float:
    return sum(step_model_flops(s).values())


def kernel_launches(s: StepShape) -> dict:
    """Each hand-written kernel of a step: ``{counter name: [(least
    seconds of one launch, launches a step), ...]}``, under the names the
    port's launch counters use, with the rows of ``counts/launches_*.py``
    merged in. The student's blocks run under full remat, so K3a and K4a
    launch twice a block. K2, K4a and K4b compute a GELU MLP: a ViT with
    another MLP kind brings its kernels' rows in a module of its own."""
    t, st, b, p = s.teacher, s.student, s.batch, s.points

    def attn_fwd(v: ViTShape, lse: bool, imp: bool):
        m, d, n = b * v.tokens, v.dim, v.tokens
        moved = (BF16 * m * d * 2 + F32 * 2 * d + BF16 * 4 * d * d
                 + F32 * 4 * d + F32 * b * (n if imp else 0)
                 + F32 * (b * v.heads * n if lse else 0)
                 + (F32 * b if lse else 0))
        flops = 2.0 * m * 4 * d * d + 4.0 * b * n * n * d
        return least_seconds(moved, flops, PEAK_BF16)

    def mlp_fwd(v: ViTShape, collect: bool):
        m, d, f = b * v.tokens, v.dim, v.hidden
        moved = (BF16 * m * d * (3 if collect else 2) + F32 * b + F32 * 2 * d
                 + BF16 * 2 * d * f + F32 * (f + d))
        return least_seconds(moved, 4.0 * m * d * f, PEAK_BF16)

    def attn_bwd(v: ViTShape):
        m, d, n = b * v.tokens, v.dim, v.tokens
        moved = (BF16 * m * d * 3 + F32 * b + F32 * b * v.heads * n
                 + F32 * 2 * d + BF16 * 4 * d * d + F32 * 3 * d
                 + F32 * 4 * d * d + F32 * 6 * d)
        flops = 2.0 * m * d * d * 11 + 12.0 * b * n * n * d
        return least_seconds(moved, flops, PEAK_BF16)

    def mlp_bwd(v: ViTShape):
        m, d, f = b * v.tokens, v.dim, v.hidden
        moved = (BF16 * m * d * 3 + F32 * b + F32 * 2 * d + BF16 * 2 * d * f
                 + F32 * f + F32 * (2 * d * f + f + 3 * d))
        return least_seconds(moved, 10.0 * m * d * f, PEAK_BF16)

    def ln_fwd(v: ViTShape):
        rows, d = b * v.tokens, v.dim
        moved = BF16 * 2 * rows * d + F32 * 2 * d + F32 * 2 * rows
        return least_seconds(moved, 8.0 * rows * d, PEAK_F32)

    def ln_bwd(v: ViTShape):
        rows, d = b * v.tokens, v.dim
        moved = BF16 * 3 * rows * d + F32 * 3 * d + F32 * 2 * rows
        return least_seconds(moved, 10.0 * rows * d, PEAK_F32)

    layers, m_flat = t.depth, b * t.tokens
    mix_in = BF16 * layers * m_flat * t.dim
    mix_out = BF16 * p * m_flat * t.dim
    mix_flops = 2.0 * p * m_flat * t.dim * layers
    polar_moved = F32 * p * b * st.dim * t.dim + BF16 * p * b * st.dim * t.dim
    # the TAW geometric slice: ops 1-5 of 14 stratified position blocks
    bounds = [round(o * b / 14) for o in range(15)]
    geo = bounds[6] - bounds[1]
    img = t.img
    out = {
        "K1 fused_block_attn": [(attn_fwd(t, lse=False, imp=True), layers)],
        "K3a fused_block_attn_train fwd": [
            (attn_fwd(st, lse=True, imp=False), 2 * st.depth)],
        "K3b fused_block_attn_train bwd": [(attn_bwd(st), st.depth)],
        "K5a fused_layernorm fwd": [(ln_fwd(t), 1), (ln_fwd(st), 1)],
        "K5b fused_layernorm bwd": [(ln_bwd(st), 1)],
        "K6a mix_stack fwd": [(least_seconds(
            mix_in + mix_out + BF16 * p * layers, mix_flops, PEAK_BF16), 1)],
        "K6b mix_stack dw": [(least_seconds(
            mix_in + mix_out + F32 * p * layers, mix_flops, PEAK_BF16), 1)],
        "K7 ns_polar_hybrid": [(least_seconds(
            polar_moved, polar_flops(p * b, st.dim, t.dim), PEAK_BF16), 1)],
        "K9 geom_shift3": [(least_seconds(
            2 * geo * img * img * 3 + F32 * 3 * geo * img + geo, 0.0,
            PEAK_F32), 1)],
    }
    if t.mlp == "gelu":
        out["K2 fused_ln_mlp_collect"] = [(mlp_fwd(t, collect=True), layers)]
    if st.mlp == "gelu":
        out["K4a fused_ln_mlp fwd"] = [
            (mlp_fwd(st, collect=False), 2 * st.depth)]
        out["K4b fused_ln_mlp bwd"] = [(mlp_bwd(st), st.depth)]
    if s.backend == "jacobi":
        r, nm = s.rank_cap, p * layers
        flops = nm * JACOBI_SWEEPS * (r - 1) * r * r
        out["K8 jacobi_eigh"] = [(least_seconds(
            F32 * nm * (2 * r * r + r), 9.0 * flops, PEAK_F32), 1)]
    for module in launch_modules():
        for name, rows in module.rows(s).items():
            out.setdefault(name, []).extend(rows)
    return out


def launch_modules() -> list:
    """The modules ``counts/launches_*.py``, in the order of their names."""
    return [importlib.import_module(f"{__name__}.{path.stem}")
            for path in sorted(Path(__file__).parent.glob("launches_*.py"))]


def kernel_bound_seconds(s: StepShape, launches: dict) -> tuple:
    """``(least seconds of the launches counted, names counted but
    unknown)``: each kernel's per-launch least times, in proportion to the
    launches its counter reports against those a step of these shapes
    makes."""
    table = kernel_launches(s)
    total, unknown = 0.0, []
    for name, count in launches.items():
        if not count:
            continue
        rows = table.get(name)
        if rows is None:
            unknown.append(name)
            continue
        per_step = sum(n for _, n in rows)
        total += sum(sec * n for sec, n in rows) * count / per_step
    return total, unknown

