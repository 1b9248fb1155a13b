"""Python wrappers of the port's hand-written Hopper kernels.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor; it counts its launches in a plain integer
attribute ``launches``. ``KERNELS`` lists them with the TPU kernel each one
replaces and its source. The six wrappers of the attention cores
(``ATTENTION_CORE``: the forward of K1, K3a, K10a and K10c, the backward of
K3b and K10b) also count each of its two variants, ``tc_launches`` (tensor
cores) and ``simt_launches`` (CUDA cores). The wrappers of K2 and K4a
(``GEMM_NK``) count their forward products by GEMM variant in
``gemm_variants`` (``gemm.gemm_nk_variant``: ``sm90``, ``wmma``, ``f32``),
two a launch; those of K3b, K4b and K11b (``GEMM_BWD``) their backward
products (``gemm.gemm_bwd_variant``), four a launch.
"""

from basd_tpu_torch.kernels.block_attn import (
    fused_block_attn,
    fused_block_attn_train_bwd,
    fused_block_attn_train_fwd,
)
from basd_tpu_torch.kernels.block_mlp import (
    fused_ln_mlp_bwd,
    fused_ln_mlp_collect,
    fused_ln_mlp_fwd,
)
from basd_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_imp,
)
from basd_tpu_torch.kernels.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
from basd_tpu_torch.kernels.geom_shift import geom_shift3
from basd_tpu_torch.kernels.jacobi_eigh import jacobi_eigh
from basd_tpu_torch.kernels.layernorm import layernorm_bwd, layernorm_fwd
from basd_tpu_torch.kernels.mix_stack import mix_stack_dw, mix_stack_fwd
from basd_tpu_torch.kernels.ns_polar import ns_polar_hybrid

_PALLAS = "basd_tpu/ops/pallas/"
_CSRC = "basd_tpu_torch/csrc/"

# (name, route, source in the repo, TPU kernel replaced, wrapper)
KERNELS = (
    ("K1 fused_block_attn", "cuda", _CSRC + "block.cu",
     _PALLAS + "fused_block_attn.py:156", fused_block_attn),
    ("K2 fused_ln_mlp_collect", "cuda", _CSRC + "block.cu",
     _PALLAS + "fused_block_mlp.py:345", fused_ln_mlp_collect),
    ("K3a fused_block_attn_train fwd", "cuda", _CSRC + "block.cu",
     _PALLAS + "fused_block_attn.py:390", fused_block_attn_train_fwd),
    ("K3b fused_block_attn_train bwd", "cuda", _CSRC + "block_train.cu",
     _PALLAS + "fused_block_attn.py:433", fused_block_attn_train_bwd),
    ("K4a fused_ln_mlp fwd", "cuda", _CSRC + "block.cu",
     _PALLAS + "fused_block_mlp.py:170", fused_ln_mlp_fwd),
    ("K4b fused_ln_mlp bwd", "cuda", _CSRC + "block_train.cu",
     _PALLAS + "fused_block_mlp.py:202", fused_ln_mlp_bwd),
    ("K5a fused_layernorm fwd", "cuda", _CSRC + "layernorm.cu",
     _PALLAS + "layernorm.py:105", layernorm_fwd),
    ("K5b fused_layernorm bwd", "triton", "basd_tpu_torch/kernels/layernorm.py",
     _PALLAS + "layernorm.py:136", layernorm_bwd),
    ("K6a mix_stack fwd", "triton", "basd_tpu_torch/kernels/mix_stack.py",
     _PALLAS + "mix_stack.py:67", mix_stack_fwd),
    ("K6b mix_stack dw", "triton", "basd_tpu_torch/kernels/mix_stack.py",
     _PALLAS + "mix_stack.py:142", mix_stack_dw),
    ("K7 ns_polar_hybrid", "cuda", _CSRC + "ns_polar.cu",
     _PALLAS + "ns_polar.py:106", ns_polar_hybrid),
    ("K8 jacobi_eigh", "cuda", _CSRC + "jacobi_eigh.cu",
     _PALLAS + "jacobi_eigh.py:215", jacobi_eigh),
    ("K9 geom_shift3", "triton", "basd_tpu_torch/kernels/geom_shift.py",
     _PALLAS + "geom_shift.py:103", geom_shift3),
    ("K10a flash_attention fwd", "cuda", _CSRC + "flash_attention.cu",
     _PALLAS + "flash_attention.py:239", flash_attention_fwd),
    ("K10b flash_attention bwd", "cuda", _CSRC + "flash_attention.cu",
     _PALLAS + "flash_attention.py:269", flash_attention_bwd),
    ("K10c flash_attention importance", "cuda", _CSRC + "flash_attention.cu",
     _PALLAS + "flash_attention.py:187", flash_attention_imp),
    ("K11a fused_mlp fwd", "cuda", _CSRC + "fused_mlp.cu",
     _PALLAS + "fused_mlp.py:165", fused_mlp_fwd),
    ("K11b fused_mlp bwd", "cuda", _CSRC + "fused_mlp.cu",
     _PALLAS + "fused_mlp.py:192", fused_mlp_bwd),
)


# the wrappers that launch the attention cores: csrc/attention.cuh's
# forward and csrc/attention_bwd.cuh's backward
ATTENTION_CORE = ("K1 fused_block_attn", "K3a fused_block_attn_train fwd",
                  "K3b fused_block_attn_train bwd", "K10a flash_attention fwd",
                  "K10b flash_attention bwd", "K10c flash_attention importance")


# the wrappers that count their forward products by GEMM variant, and
# those that count their backward products
GEMM_NK = ("K2 fused_ln_mlp_collect", "K4a fused_ln_mlp fwd")
GEMM_BWD = ("K3b fused_block_attn_train bwd", "K4b fused_ln_mlp bwd",
            "K11b fused_mlp bwd")


def reset_launch_counts() -> None:
    for name, *_, fn in KERNELS:
        fn.launches = 0
        if name in ATTENTION_CORE:
            fn.tc_launches = fn.simt_launches = 0
        if name in GEMM_NK + GEMM_BWD:
            fn.gemm_variants = dict.fromkeys(fn.gemm_variants, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, *_, fn in KERNELS}


def variant_counts() -> dict[str, dict[str, int]]:
    """Launches of each attention-core wrapper by variant, tc and simt."""
    return {name: {"tc": fn.tc_launches, "simt": fn.simt_launches}
            for name, *_, fn in KERNELS if name in ATTENTION_CORE}


def gemm_variant_counts(group=GEMM_NK) -> dict[str, dict[str, int]]:
    """Products of each wrapper of ``group`` (``GEMM_NK``: the forward
    ones; ``GEMM_BWD``: the backward ones) by GEMM variant."""
    return {name: dict(fn.gemm_variants) for name, *_, fn in KERNELS
            if name in group}
