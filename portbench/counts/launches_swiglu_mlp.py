"""K2g (``basd_tpu_torch/csrc/block.cu:basd_block_swiglu_fwd``, counter
``K2g fused_ln_swiglu_collect``): a SwiGLU teacher's MLP half, one launch
a teacher block a step. A launch counts fc1's 2 F outputs and fc2's F
inputs a row, 2 M D 2F + 2 M F D operations at the bf16 peak, against the
bytes of x, the weights and biases, the (M, F) hidden state written once,
and the output with its slab of the stack, as K2's count does. A GELU
teacher has no rows here: its MLP half is K2's."""

from portbench import counts

COUNTER = "K2g fused_ln_swiglu_collect"


def launch_seconds(v: counts.ViTShape, b: int) -> float:
    m, d, f = b * v.tokens, v.dim, v.hidden
    moved = (counts.BF16 * m * d * 3 + counts.F32 * b + counts.F32 * 2 * d
             + counts.BF16 * 3 * d * f + counts.F32 * (2 * f + d)
             + counts.BF16 * m * f)
    return counts.least_seconds(moved, 6.0 * m * d * f, counts.PEAK_BF16)


def rows(s: counts.StepShape) -> dict:
    t = s.teacher
    if t.mlp != "swiglu":
        return {}
    return {COUNTER: [(launch_seconds(t, s.batch), t.depth)]}
