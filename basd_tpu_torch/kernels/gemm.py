"""The dispatch rules of the block kernels' GEMM, mirrored from csrc.

Every bf16 product of K1-K4 and K11 runs on ``csrc/gemm_sm90.cuh``'s wgmma
GEMM where its rule allows, on ``common.cuh``'s WMMA tile otherwise; f32
products run on the CUDA-core tile. The C side decides before each launch;
these functions decide the same from the shapes, dtypes and addresses, so
a wrapper can size its workspaces and count the variant each product took
(``gemm_variants`` on the K2, K4a, K3b, K4b and K11b wrappers).

- ``gemm_nk_variant``: a forward product ``A (M, K) . W (N, K)^T``
  (``block_kernels.cuh:launch_gemm_nk``, ``gemm_sm90.cuh:gemm_nk_tile_n``).
- ``gemm_bwd_variant``: a backward product (``launch_gemm_bwd``,
  ``gemm_bwd_tile_n``): the input gradients ``dY W``, the GELU-gradient
  and rounded products (B MN-major) and the weight gradients ``dY^T X``
  (both MN-major).
- ``split_k_chunk``: the contraction rows of one split of a weight
  gradient (``gemm_sm90.cuh:split_k_chunk``); the split count depends on
  the shapes only.
"""

from __future__ import annotations

import torch

SM90_TM = 128  # rows of the sm90 GEMM's tile
SM90_TK = 64  # contraction rows of one stage of its ring
WMMA_TM = 64  # rows of the WMMA and f32 tiles
SPLIT_TILE_N = 64  # the sm90 tile width of a split-K weight gradient
SPLIT_TARGET = 198  # CTAs a split-K product aims for: 1.5 per SM of an H100


def sm90_tile_n(n: int) -> int:
    """The sm90 GEMM's tile width for ``n`` output columns."""
    return 128 if n >= 256 else 64


def _sm90_ok(lds, ptrs) -> bool:
    return (all(ld > 0 and ld % 8 == 0 for ld in lds)
            and all(p % 16 == 0 for p in ptrs))


def gemm_nk_variant(dtype, n: int, k: int, ptrs) -> str:
    """The GEMM a forward product ``out (M, n) = A (M, k) . W (n, k)^T``
    takes (``n`` does not enter the rule; it sets the tile width,
    ``sm90_tile_n``): ``'sm90'`` (the wgmma GEMM) for bf16 with k % 8 == 0
    and every address in ``ptrs`` (A, W and out) 16-byte aligned;
    ``'wmma'`` (common.cuh's tile) for other bf16 operands; ``'f32'`` (the
    CUDA-core tile) for f32."""
    return gemm_bwd_variant(dtype, (k,), ptrs)


def gemm_bwd_variant(dtype, lds, ptrs) -> str:
    """The GEMM a backward product takes: ``'sm90'`` for bf16 whose leading
    dimensions ``lds`` (A's and B's) are multiples of 8 and whose addresses
    ``ptrs`` (the operands, outputs and the epilogue's input; 0 for none)
    are 16-byte aligned; ``'wmma'`` for other bf16 operands; ``'f32'`` for
    f32."""
    if dtype == torch.float32:
        return "f32"
    return "sm90" if _sm90_ok(lds, ptrs) else "wmma"


def gemm_tile_m(variant: str) -> int:
    """Rows of one output tile of ``variant``: the GELU-gradient epilogue
    writes one column-sum row per row tile."""
    return SM90_TM if variant == "sm90" else WMMA_TM


def split_k_chunk(rows: int, m: int, n: int,
                  target: int = SPLIT_TARGET) -> int:
    """Contraction rows per split of a weight gradient ``dW (m, n)`` summed
    over ``rows`` rows: enough splits of the sm90 tile grid (128 x
    ``SPLIT_TILE_N``) for about ``target`` CTAs, each a whole number of
    64-row stages. The splits cover rows 0..rows-1 once each, in order,
    whatever the card (``tune.py`` alone passes another ``target``)."""
    tiles = -(-m // SM90_TM) * -(-n // SPLIT_TILE_N)
    stages = -(-rows // SM90_TK)
    splits = max(1, min(stages, -(-target // tiles)))
    return -(-stages // splits) * SM90_TK


def weight_grad_floats(rows: int, shapes) -> int:
    """f32 elements of the split-K partials of the weight gradients of
    ``shapes`` ((m, n) each) over ``rows`` rows, one at a time."""
    return max(-(-rows // split_k_chunk(rows, m, n)) * m * n
               for m, n in shapes)


def count_products(fn, dtype, products) -> None:
    """Adds each product's variant to ``fn.gemm_variants``; ``products``:
    (leading dimensions, tensors or None) of each backward product."""
    for lds, tensors in products:
        ptrs = [0 if t is None else t.data_ptr() for t in tensors]
        fn.gemm_variants[gemm_bwd_variant(dtype, lds, ptrs)] += 1
