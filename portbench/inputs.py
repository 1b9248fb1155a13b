"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the teacher's and the student's weights, the selector's
frozen projections, and the traffic's pool of uint8 canvases with their
labels. Everything is drawn on the device from ``torch.Generator``s in a
few large calls, so the same seed on the same card gives the same bits to
both sides, and the reference can make them again after the window."""

from __future__ import annotations

import math

import torch

from portbench.counts import mlp_of

_SALTS = {"teacher": 1, "student": 2, "selector": 3, "canvas": 4, "run": 5}
# canvases drawn per call; the draws follow it, so it is fixed for every cell
CHUNK = 256


def sub_seed(seed: int, what: str) -> int:
    """A seed of its own for each thing drawn from ``seed``; any whole
    number, also beyond 32 bits."""
    return (int(seed) * 0x9E3779B1 + _SALTS[what] * 0x632BE5AB) % (2 ** 63)


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def vit_leaves(m: dict, img: int, num_classes: int) -> list:
    """(name, shape) of a ViT's parameters, in timm's names and (out, in)
    layouts, as the port's modules hold them. A SwiGLU MLP's ``fc1`` is
    timm's packed ``SwiGLUPacked`` layer, (2 F, D) with [a | g]."""
    d, p = m["embed_dim"], m["patch_size"]
    kind, f = mlp_of(m)
    f1 = 2 * f if kind == "swiglu" else f
    n = (img // p) ** 2 + 1
    out = [("cls_token", (1, 1, d)), ("pos_embed", (1, n, d)),
           ("patch_embed.proj.weight", (d, 3, p, p)),
           ("patch_embed.proj.bias", (d,))]
    for i in range(m["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
                (b + "attn.qkv.weight", (3 * d, d)),
                (b + "attn.qkv.bias", (3 * d,)),
                (b + "attn.proj.weight", (d, d)), (b + "attn.proj.bias", (d,))]
        if m.get("layerscale"):
            out.append((b + "ls1.gamma", (d,)))
        out += [(b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
                (b + "mlp.fc1.weight", (f1, d)), (b + "mlp.fc1.bias", (f1,)),
                (b + "mlp.fc2.weight", (d, f)), (b + "mlp.fc2.bias", (d,))]
        if m.get("layerscale"):
            out.append((b + "ls2.gamma", (d,)))
    out += [("norm.weight", (d,)), ("norm.bias", (d,))]
    if num_classes:
        out += [("head.weight", (num_classes, d)), ("head.bias", (num_classes,))]
    return out


def _leaf_law(name: str, shape: tuple, law: dict):
    """(mean, std) of one leaf under the configuration's weight law."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "cls_token":
        return 0.0, law["cls_std"]
    if name == "pos_embed":
        return 0.0, law["pos_std"]
    if leaf == "gamma":
        return law["layerscale"], law["layerscale"] * law["layerscale_spread"]
    if "norm" in name.rsplit(".", 2)[-2]:
        return (1.0, law["norm_weight_std"]) if leaf == "weight" else (
            0.0, law["norm_bias_std"])
    if leaf == "bias":
        return 0.0, law["bias_std"]
    fan_in = math.prod(shape[1:])
    if name.startswith("patch_embed") and law.get("patch_fan_out"):
        fan_in = shape[0] * shape[2] * shape[3]
    return 0.0, math.sqrt(law["gain"] / fan_in)


def make_vit_weights(m: dict, img: int, num_classes: int, law: dict,
                     seed: int, device) -> dict:
    """A ViT's f32 weights from ``seed``: one normal draw for all leaves,
    each slice scaled to its leaf's law (``_leaf_law``)."""
    leaves = vit_leaves(m, img, num_classes)
    total = sum(math.prod(s) for _, s in leaves)
    z = torch.randn(total, generator=_gen(device, seed), device=device)
    out, i = {}, 0
    for name, shape in leaves:
        k = math.prod(shape)
        mean, std = _leaf_law(name, shape, law)
        w = z[i:i + k].view(shape)
        if name == "pos_embed":  # truncated at 2 std, as timm's init
            w = w.clamp(-2.0, 2.0)
        out[name] = (w * std + mean) if std else torch.full(
            shape, float(mean), device=device)
        i += k
    return out


def orthonormal(g: torch.Generator, rows: int, cols: int, device):
    """A (rows, cols) matrix with orthonormal rows (rows <= cols) or
    columns: QR of a normal draw, signs fixed by R's diagonal."""
    flat = torch.randn((max(rows, cols), min(rows, cols)), generator=g,
                       device=device)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.t() if rows < cols else q).contiguous()


def make_selector(d_s: int, d_t: int, points: int, seed: int, device):
    """The selector's frozen projections and initial log-temperatures
    (softplus^-1(1), as the BASD loss starts)."""
    g = _gen(device, seed)
    buffers = {"proj_s": orthonormal(g, d_s, d_s, device),
               "proj_t": orthonormal(g, d_s, d_t, device)}
    temps = torch.full((points,), math.log(math.e - 1.0), device=device)
    return buffers, temps


def make_canvases(traffic: dict, num_classes: int, seed: int, device):
    """The traffic's pool: ``pool`` batches of (B, R, R, 3) uint8 canvases
    and (B,) int64 labels. Each image is a class-dependent low-frequency
    field plus per-pixel normal noise, clipped and truncated to uint8 (the
    pattern of the port's synthetic source, drawn on the device)."""
    g = _gen(device, seed)
    b, r, pool = traffic["batch"], traffic["canvas"], traffic["pool"]
    noise = float(traffic["noise_std"])
    amp = float(traffic["amplitude"])
    grid = torch.arange(r, device=device, dtype=torch.float32) / max(r - 1, 1)
    yy, xx = grid[:, None], grid[None, :]
    two_pi = 2.0 * math.pi
    images, labels = [], []
    for _ in range(pool):
        lab = torch.randint(0, num_classes, (b,), generator=g, device=device)
        img = torch.empty((b, r, r, 3), dtype=torch.uint8, device=device)
        for s in range(0, b, CHUNK):
            ph = (two_pi * lab[s:s + CHUNK].float() / num_classes)[:, None, None]
            base = torch.stack([
                0.5 + amp * torch.sin(two_pi * (yy + xx) + ph),
                0.5 + amp * torch.cos(two_pi * (yy - xx) + 2 * ph),
                0.5 + amp * torch.sin(2 * two_pi * yy + 3 * ph).expand_as(
                    yy + xx + ph),
            ], dim=-1)
            z = torch.randn(base.shape, generator=g, device=device)
            img[s:s + CHUNK] = ((base + noise * z).clamp(0.0, 1.0)
                                * 255.0).to(torch.uint8)
        images.append(img)
        labels.append(lab)
    return images, labels


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """Everything both sides take, from ``seed``."""
    img, c = config["img_size"], config["num_classes"]
    t, s = config["teacher"], config["student"]
    buffers, temps = make_selector(
        s["embed_dim"], t["embed_dim"], config["basd"]["num_extraction_points"],
        sub_seed(seed, "selector"), device)
    images, labels = make_canvases(traffic, c, sub_seed(seed, "canvas"),
                                   device)
    return {
        "teacher": make_vit_weights(t, img, 0, config["weights"]["teacher"],
                                    sub_seed(seed, "teacher"), device),
        "student": make_vit_weights(s, img, c, config["weights"]["student"],
                                    sub_seed(seed, "student"), device),
        "selector": buffers,
        "log_temperatures": temps,
        "images": images,
        "labels": labels,
        "run_seed": sub_seed(seed, "run"),
    }
