"""The port's SwiGLU MLP (a DINOv2 ViT-g/14 teacher's): the module chain of
``Block`` and a collecting ``VisionTransformer`` against the benchmark's
plain PyTorch reference (``portbench/reference/model.py``, which imports
neither JAX nor a kernel of the port), K2g's wrapper on the CPU (its plain
version), the ``dinov2_vitg14`` preset, the timm and DINOv2-hub layouts of a
checkpoint, K6's gate on a 40-layer stack, the refusal of tensor
parallelism, and the GELU blocks as they were. The test marked ``card``
holds K2g against its plain version on the card and skips here."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from basd_tpu_torch.kernels import block_mlp, mix_stack
from basd_tpu_torch.models import port
from basd_tpu_torch.models.layers import Block, block_mlp_path
from basd_tpu_torch.models.registry import (
    _VIT_PRESETS,
    _vit_info,
    create_model,
)
from basd_tpu_torch.models.vit import ViTConfig
from basd_tpu_torch.parallel.mesh import ModelParallel
from portbench.inputs import make_vit_weights
from portbench.reference import model as ref
from portbench.reference.arith import Arith

EPS = 1e-6
IMG = 32
# a tiny SwiGLU teacher: 3 blocks, D 64, 2 heads, patch 8 (17 tokens), F 128
ARCH = dict(embed_dim=64, depth=3, num_heads=2, patch_size=8,
            mlp="swiglu", mlp_hidden=128, layerscale_init=1.0)
ENTRY = dict(embed_dim=64, depth=3, num_heads=2, mlp_ratio=4.0, patch_size=8,
             layerscale=True, mlp="swiglu", mlp_hidden=128)
LAW = {"gain": 1.0, "bias_std": 0.02, "norm_weight_std": 0.1,
       "norm_bias_std": 0.02, "cls_std": 0.02, "pos_std": 0.02,
       "layerscale": 0.5, "layerscale_spread": 0.1}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    return torch.device("cuda")


def weights(seed: int = 3) -> dict:
    return make_vit_weights(ENTRY, IMG, 0, LAW, seed, "cpu")


def teacher(dtype=torch.float32):
    bundle = create_model("tiny_swiglu", img_size=IMG, arch_overrides=ARCH,
                          importance_mode="cls", collect=True, dtype=dtype)
    bundle.module.load_state_dict(weights(), strict=True)
    return bundle.module.eval().requires_grad_(False)


def images(b: int = 2):
    g = torch.Generator().manual_seed(1)
    return torch.rand(b, IMG, IMG, 3, generator=g)


def mlp_half_reference(x, wts: dict, i: int):
    """The reference block's MLP half: x + gamma fc2(silu(a) g)."""
    pre = f"blocks.{i}."
    h = ref.layer_norm(x, wts[pre + "norm2.weight"], wts[pre + "norm2.bias"],
                       EPS)
    y = ref.mlp(Arith("f32"), h, wts, pre + "mlp.", "swiglu", "none")
    return x + wts[pre + "ls2.gamma"] * y


@pytest.mark.parametrize("what", ["block", "vit"])
def test_module_chain_matches_reference(what):
    wts = weights()
    if what == "block":
        blk = Block(64, 2, 4.0, importance_mode="cls", layerscale_init=1.0,
                    mlp="swiglu", mlp_hidden=128)
        blk.load_state_dict({k[len("blocks.1."):]: v for k, v in wts.items()
                             if k.startswith("blocks.1.")}, strict=True)
        x = torch.randn(2, 17, 64, generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            got, imp = blk(x)
        want, want_imp = ref.block(Arith("f32"), x, wts, 1, 2, EPS, "none",
                                   importance=True, kind="swiglu")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(imp, want_imp, rtol=1e-5, atol=1e-6)
        return
    x = images()
    with torch.no_grad():
        out = teacher()(x)
    stack = out["tokens"].flat.view(3, 2, 17, 64)
    want, want_imp = ref.teacher_forward(Arith("f32"), wts, x, ENTRY, EPS,
                                         "none")
    torch.testing.assert_close(stack, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out["importance"], want_imp, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2g_plain_matches_reference(dtype):
    """K2g's wrapper on CPU tensors is its plain version, with the slab
    written and no launch counted; at f32 it is the reference's MLP half
    (LayerScale folded into fc2), at bf16 within bf16 rounding of it."""
    wts = weights()
    pre = "blocks.2."
    g = wts[pre + "ls2.gamma"]
    x = torch.randn(2, 17, 64, generator=torch.Generator().manual_seed(5))
    args = (x.to(dtype), torch.ones(2), wts[pre + "norm2.weight"],
            wts[pre + "norm2.bias"], wts[pre + "mlp.fc1.weight"].to(dtype),
            wts[pre + "mlp.fc1.bias"],
            (wts[pre + "mlp.fc2.weight"] * g[:, None]).to(dtype),
            wts[pre + "mlp.fc2.bias"] * g)
    buf = torch.full((3 * 34, 64), 7.0, dtype=dtype)
    before = block_mlp.fused_ln_swiglu_collect.launches
    out = block_mlp.fused_ln_swiglu_collect(*args, buf, 1, EPS)
    assert block_mlp.fused_ln_swiglu_collect.launches == before
    assert torch.equal(out, block_mlp.swiglu_mlp_plain(*args, EPS))
    assert torch.equal(buf[34:68], out.reshape(34, 64))
    assert bool((buf[:34] == 7.0).all() and (buf[68:] == 7.0).all())
    want = mlp_half_reference(x.to(dtype).float(), wts, 2)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


def test_block_dispatches_swiglu_to_k2g():
    # bf16 3-D on CUDA takes K2g, with or without a stack; f32, 2-D or the
    # CPU keep the module chain; GELU's table is as it was
    bf, f32 = torch.bfloat16, torch.float32
    assert block_mlp_path("auto", True, bf, 3, "swiglu") == "fused_ln"
    assert block_mlp_path("fused_ln", False, bf, 3, "swiglu") == "fused_ln"
    assert block_mlp_path("auto", True, f32, 3, "swiglu") == "auto"
    assert block_mlp_path("fused_ln", True, f32, 3, "swiglu") == "auto"
    assert block_mlp_path("auto", True, bf, 2, "swiglu") == "auto"
    assert block_mlp_path("auto", False, bf, 3, "swiglu") == "auto"
    for impl in ("auto", "fused_ln", "module"):
        for cuda in (True, False):
            for dt in (bf, f32):
                assert block_mlp_path(impl, cuda, dt, 3) == block_mlp_path(
                    impl, cuda, dt, 3, "gelu")
    assert block_mlp_path("fused_ln", True, f32, 3) == "fused_ln"
    # an explicit fused_ln at bf16 on the CPU: K2g's plain version, and
    # under autograd the module chain (K2g has no backward)
    blk = Block(64, 2, 4.0, importance_mode="cls", dtype=bf,
                mlp_impl="fused_ln", mlp="swiglu", mlp_hidden=128)
    x = torch.randn(2, 17, 64).to(bf)
    assert blk._mlp_path(x) == "auto"
    with torch.no_grad():
        assert blk._mlp_path(x) == "fused_ln"


def test_vitg14_preset_and_info():
    preset = dict(_VIT_PRESETS["dinov2_vitg14"])
    cfg = ViTConfig(img_size=224, patch_size=preset.pop("patch_size"),
                    num_classes=0,
                    layerscale_init=preset.pop("layerscale_init"), **preset)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size) == (
        1536, 40, 24, 14)
    assert (cfg.mlp, cfg.hidden_dim, cfg.layerscale_init) == (
        "swiglu", 4096, 1e-5)
    info = _vit_info(cfg)
    assert info["heads_per_layer"] == [24] * 40
    assert (info["mlp"], info["mlp_hidden"], info["num_tokens"]) == (
        "swiglu", 4096, 256)
    # the whole model on the meta device: shapes, no storage
    with torch.device("meta"):
        bundle = create_model("dinov2_vitg14", img_size=224)
    params = dict(bundle.module.named_parameters())
    assert sum(p.numel() for p in params.values()) == 1_134_769_664
    assert params["blocks.39.mlp.fc1.weight"].shape == (8192, 1536)
    assert params["blocks.39.mlp.fc2.weight"].shape == (1536, 4096)
    with pytest.raises(ValueError, match="mlp_hidden"):
        ViTConfig(mlp="swiglu")
    with pytest.raises(ValueError, match="unknown MLP kind"):
        ViTConfig(mlp="relu")
    assert ViTConfig().with_overrides({"mlp": "swiglu", "mlp_hidden": 8}).mlp \
        == "swiglu"


@pytest.mark.parametrize("layout", ["timm", "dinov2_hub"])
def test_checkpoint_layouts_load_and_match(layout):
    """timm's packed ``mlp.fc1`` loads as it is; DINOv2's hub ``mlp.w12`` /
    ``mlp.w3`` (and ``gamma_1`` / ``gamma_2``) are renamed; either gives
    the reference's output."""
    wts = weights()
    sd = dict(wts)
    if layout == "dinov2_hub":
        sd = {k.replace("mlp.fc1.", "mlp.w12.").replace("mlp.fc2.", "mlp.w3.")
              .replace("ls1.gamma", "gamma_1").replace("ls2.gamma", "gamma_2"):
              v for k, v in wts.items()}
        sd["mask_token"] = torch.zeros(1, 64)
        derived = port.derive_arch_from_state_dict(sd)
        assert (derived["mlp"], derived["mlp_hidden"], derived["depth"]) == (
            "swiglu", 128, 3)
    bundle = create_model("tiny_swiglu", img_size=IMG, arch_overrides=ARCH,
                          importance_mode="cls", collect=True)
    port.port_torch_checkpoint(sd, bundle)
    x = images()
    with torch.no_grad():
        out = bundle.module(x)
    want, _ = ref.teacher_forward(Arith("f32"), wts, x, ENTRY, EPS, "none")
    torch.testing.assert_close(out["tokens"].flat.view(3, 2, 17, 64), want,
                               rtol=1e-5, atol=1e-5)


def test_mix_kernel_takes_a_vitg14_stack():
    m = 256 * 257
    assert mix_stack.kernel_eligible((40, m, 1536), True)
    assert mix_stack.kernel_eligible((12, m, 768), True)
    assert not mix_stack.kernel_eligible((40, m + 4, 1536), True)
    assert not mix_stack.kernel_eligible((40, m, 1536), False)


def test_tensor_parallelism_refuses_swiglu():
    wts = weights()
    with pytest.raises(ValueError, match=r"packs \[a \| g\]"):
        port.shard_state_dict(wts, ModelParallel(0, 2), 2)
    blk = Block(64, 2, 4.0, mlp="swiglu", mlp_hidden=128)
    with pytest.raises(ValueError, match=r"packs \[a \| g\]"):
        blk.set_tp(ModelParallel(0, 2), {})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_block_unchanged(dtype):
    """A GELU block's parameters and module chain are those of before the
    MLP kind: fc1 (F, D), fc2 (D, F), out = x + fc2(gelu(fc1(LN2(x))))
    bit for bit, tanh-GELU at bf16 and erf at f32."""
    torch.manual_seed(6)
    blk = Block(32, 2, 4.0, dtype=dtype)
    shapes = {k: tuple(v.shape) for k, v in blk.state_dict().items()
              if ".mlp." in "." + k}
    assert shapes == {"mlp.fc1.weight": (128, 32), "mlp.fc1.bias": (128,),
                      "mlp.fc2.weight": (32, 128), "mlp.fc2.bias": (32,)}
    assert blk.mlp.kind == "gelu"
    x = torch.randn(2, 5, 32).to(dtype)
    with torch.no_grad():
        got, _ = blk(x)
        y = x + blk.attn(blk.norm1(x), "einsum")[0]
        approx = "tanh" if dtype == torch.bfloat16 else "none"
        h = F.gelu(blk.mlp.fc1(blk.norm2(y)), approximate=approx)
        want = y + blk.mlp.fc2(h)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("collect", [False, True])
def test_k2g_kernel_matches_plain(card, collect):
    """K2g on the card at the ViT-g/14 widths (2 images of 257 tokens, D
    1536, F 4096) against its plain version, with and without its slab."""
    g = torch.Generator(device=card).manual_seed(11)
    bf = torch.bfloat16
    b, n, d, f = 2, 257, 1536, 4096

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=card) * scale

    args = (rn(b, n, d).to(bf), torch.ones(b, device=card), 1.0 + 0.1 * rn(d),
            0.1 * rn(d), rn(2 * f, d, scale=d ** -0.5).to(bf), 0.1 * rn(2 * f),
            rn(d, f, scale=f ** -0.5).to(bf), 0.1 * rn(d))
    m = b * n
    buf = (torch.full((3 * m, d), 7.0, dtype=bf, device=card) if collect
           else None)
    before = block_mlp.fused_ln_swiglu_collect.launches
    out = block_mlp.fused_ln_swiglu_collect(*args, buf, 2)
    want = block_mlp.swiglu_mlp_plain(*args)
    torch.cuda.synchronize()
    assert block_mlp.fused_ln_swiglu_collect.launches == before + 1
    err = (out.float() - want.float()).abs().max().item()
    assert err <= 2 ** -5 * max(want.float().abs().max().item(), 1.0), err
    if collect:
        assert torch.equal(buf[2 * m:], out.reshape(m, d))
        assert bool((buf[:2 * m] == 7.0).all())


@pytest.mark.card
def test_mix_kernel_past_2_31_elements(card):
    """K6 on a 40-layer stack of more than 2^31 elements (the ViT-g/14
    stack at B=256 holds 4.0e9): the forward picks the last layer exactly
    with one-hot weights, the weight gradient sums every layer."""
    num_l, m, d = 40, 65536, 832
    n = m * d
    assert num_l * n > 2 ** 31
    t = torch.empty((num_l, m, d), dtype=torch.bfloat16, device=card)
    for l in range(num_l):
        t[l].fill_((l + 1) * 2.0 ** -6)
    w = torch.zeros((4, num_l), device=card)
    w[torch.arange(4), torch.tensor([0, 13, 38, 39])] = 1.0
    out = mix_stack.mix_stack_fwd(w, t)
    for p, l in enumerate((0, 13, 38, 39)):
        assert bool((out[p] == (l + 1) * 2.0 ** -6).all()), (p, l)
    del out
    g = torch.full((4, m, d), 2.0 ** -10, dtype=torch.bfloat16, device=card)
    dw = mix_stack.mix_stack_dw(g, t)
    want = torch.arange(1, num_l + 1, device=card) * 2.0 ** -16 * n
    torch.testing.assert_close(dw, want.expand(4, -1), rtol=1e-4, atol=0)
