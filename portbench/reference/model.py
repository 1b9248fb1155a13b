"""A pre-LayerNorm ViT in plain PyTorch on a dict of weights (timm's names
and (out, in) layouts): patch embedding as a stride-p product, CLS token,
learned positions, blocks of multi-head attention and an MLP, each branch
with optional LayerScale and per-image stochastic depth, final LayerNorm
and a linear head on the CLS token. The frozen teacher also returns every
block's output and the CLS-query attention importance over the patch keys,
averaged over heads. The MLP is the configuration entry's kind
(``counts.mlp_of``): GELU, fc2(gelu(fc1(h))), or SwiGLU, fc2(silu(a) * g)
with [a | g] = fc1(h) (DINOv2's ``SwiGLUFFN``, timm's ``GluMlp`` with
``gate_last=False``). GELU is the tanh form where the configuration
computes in bfloat16 and erf where it computes in float32, as the BASD
package defines them; LayerNorm statistics are float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.counts import mlp_of
from portbench.reference.arith import Arith


def layer_norm(x, w, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def patch_embed(ar: Arith, x_nhwc, w, b):
    """(B, S, S, 3) -> (B, N, D): each p x p patch flattened in (c, dy, dx)
    order against the (D, 3, p, p) kernel."""
    bsz, s, _, c = x_nhwc.shape
    d, _, p, _ = w.shape
    g = s // p
    x = x_nhwc[:, :g * p, :g * p].reshape(bsz, g, p, g, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(bsz, g * g, c * p * p)
    return ar.linear(x, w.reshape(d, -1), b)


def attention(ar: Arith, x, wts: dict, pre: str, heads: int,
              importance: bool):
    bsz, n, d = x.shape
    e = d // heads
    qkv = ar.linear(x, wts[pre + "qkv.weight"], wts[pre + "qkv.bias"])
    q, k, v = (t.reshape(bsz, n, heads, e).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    scores = ar.bmm(q, k.transpose(-1, -2)) * e ** -0.5
    probs = torch.softmax(scores, dim=-1)
    imp = probs[:, :, 0, 1:].mean(1) if importance else None
    out = ar.bmm(probs, v).transpose(1, 2).reshape(bsz, n, d)
    return ar.linear(out, wts[pre + "proj.weight"], wts[pre + "proj.bias"]), imp


def mlp(ar: Arith, h, wts: dict, pre: str, kind: str, gelu: str):
    """The MLP of kind 'gelu' or 'swiglu' (its F from fc2's width)."""
    u = ar.linear(h, wts[pre + "fc1.weight"], wts[pre + "fc1.bias"])
    if kind == "swiglu":
        f = wts[pre + "fc2.weight"].shape[1]
        u = F.silu(u[..., :f]) * u[..., f:]
    else:
        u = F.gelu(u, approximate=gelu)
    return ar.linear(u, wts[pre + "fc2.weight"], wts[pre + "fc2.bias"])


def block(ar: Arith, x, wts: dict, i: int, heads: int, eps: float,
          gelu: str, keep=None, masks=None, importance: bool = False,
          kind: str = "gelu"):
    """One block; ``keep``: the block's keep probability and ``masks`` its
    (2, B) draws for the two branches' stochastic depth; ``kind``: the
    MLP's."""
    pre = f"blocks.{i}."

    def branch(y, j):
        gamma = wts.get(pre + f"ls{j + 1}.gamma")
        if gamma is not None:
            y = y * gamma
        if masks is not None:
            y = y * torch.where(masks[j], 1.0 / keep, 0.0)[:, None, None]
        return y

    h = layer_norm(x, wts[pre + "norm1.weight"], wts[pre + "norm1.bias"], eps)
    y, imp = attention(ar, h, wts, pre + "attn.", heads, importance)
    x = x + branch(y, 0)
    h = layer_norm(x, wts[pre + "norm2.weight"], wts[pre + "norm2.bias"], eps)
    y = mlp(ar, h, wts, pre + "mlp.", kind, gelu)
    return x + branch(y, 1), imp


def embed(ar: Arith, wts: dict, images):
    x = patch_embed(ar, images, wts["patch_embed.proj.weight"],
                    wts["patch_embed.proj.bias"])
    cls = wts["cls_token"].expand(x.shape[0], 1, -1)
    return torch.cat([cls, x], dim=1) + wts["pos_embed"]


@torch.no_grad()
def teacher_forward(ar: Arith, wts: dict, images, m: dict, eps: float,
                    gelu: str):
    """Every block's output (L, B, N, D) with the CLS row, and the CLS
    importance (L, B, N - 1)."""
    x = embed(ar, wts, images)
    kind = mlp_of(m)[0]
    outs, imps = [], []
    for i in range(m["depth"]):
        x, imp = block(ar, x, wts, i, m["num_heads"], eps, gelu,
                       importance=True, kind=kind)
        outs.append(x)
        imps.append(imp)
    return torch.stack(outs), torch.stack(imps)


def student_forward(ar: Arith, wts: dict, images, m: dict, eps: float,
                    gelu: str, draws: dict, token_layers: list):
    """(logits, the (P, B, N - 1, D) tokens at ``token_layers``), each block
    recomputed in the backward to hold the memory down."""
    x = embed(ar, wts, images)
    kind = mlp_of(m)[0]
    tokens = {}
    for i in range(m["depth"]):
        keep, masks = None, None
        if draws.get("keep_rates") is not None:
            keep, masks = draws["keep_rates"][i], draws["drop_masks"][i]

        def run(x_in, i=i, keep=keep, masks=masks):
            return block(ar, x_in, wts, i, m["num_heads"], eps, gelu,
                         keep, masks, kind=kind)[0]

        x = checkpoint(run, x, use_reentrant=False)
        if i in token_layers:
            tokens[i] = x[:, 1:]
    x = layer_norm(x, wts["norm.weight"], wts["norm.bias"], eps)
    logits = ar.linear(x[:, 0], wts["head.weight"], wts["head.bias"])
    return logits, torch.stack([tokens[i] for i in token_layers])
