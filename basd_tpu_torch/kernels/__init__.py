"""Python wrappers of the port's hand-written Hopper kernels.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor; it counts its launches in a plain integer
attribute ``launches``. ``KERNELS`` lists them with the TPU kernel each one
replaces and its source.
"""

from basd_tpu_torch.kernels.block_attn import fused_block_attn
from basd_tpu_torch.kernels.block_mlp import fused_ln_mlp_collect
from basd_tpu_torch.kernels.mix_stack import mix_stack_dw, mix_stack_fwd
from basd_tpu_torch.kernels.ns_polar import ns_polar_hybrid

# (name, route, source in the repo, TPU kernel replaced, wrapper)
KERNELS = (
    ("K1 fused_block_attn", "cuda", "basd_tpu_torch/csrc/block.cu",
     "basd_tpu/ops/pallas/fused_block_attn.py:156", fused_block_attn),
    ("K2 fused_ln_mlp_collect", "cuda", "basd_tpu_torch/csrc/block.cu",
     "basd_tpu/ops/pallas/fused_block_mlp.py:345", fused_ln_mlp_collect),
    ("K6a mix_stack fwd", "triton", "basd_tpu_torch/kernels/mix_stack.py",
     "basd_tpu/ops/pallas/mix_stack.py:67", mix_stack_fwd),
    ("K6b mix_stack dw", "triton", "basd_tpu_torch/kernels/mix_stack.py",
     "basd_tpu/ops/pallas/mix_stack.py:142", mix_stack_dw),
    ("K7 ns_polar_hybrid", "cuda", "basd_tpu_torch/csrc/ns_polar.cu",
     "basd_tpu/ops/pallas/ns_polar.py:106", ns_polar_hybrid),
)


def reset_launch_counts() -> None:
    for *_, fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, *_, fn in KERNELS}
