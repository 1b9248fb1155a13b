"""The reference's first train steps of a cell, from the inputs that the
benchmark makes from the seed: views, teacher, student forward and
backward, the BASD loss and schedule-free AdamW, run from the same
initial state and the same draws as the program. Returns what the check
compares: each step's loss, each leaf's first gradient norm and each
leaf's change after the steps (on the host)."""

from __future__ import annotations

import torch

from portbench.inputs import make_inputs
from portbench.reference import loss as ref_loss
from portbench.reference import model, views
from portbench.reference.arith import Arith

STUDENT = "student."
TEMPS = "basd.log_temperatures"
B1, B2, EPS = 0.9, 0.999, 1e-8
# the leaf whose gradient the 'grad' fault doubles
FAULT_LEAF = STUDENT + "blocks.0.attn.qkv.weight"
# the small leaf whose gradient the 'lnbias' fault zeroes
LN_FAULT_LEAF = STUDENT + "blocks.5.norm1.bias"


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def token_layers(depth: int, points: int) -> list:
    if points == 1:
        return [depth - 1]
    return [round(i * (depth - 1) / (points - 1)) for i in range(points)]


class ScheduleFree:
    """Schedule-free AdamW (Defazio et al.) on a dict of f32 leaves, its
    scalar schedule in f32: y = b1 x + (1 - b1) z is the gradient point."""

    def __init__(self, params: dict, lr: float, weight_decay: float):
        self.x = {k: p.detach().clone() for k, p in params.items()}
        self.z = {k: p.detach().clone() for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.lr, self.wd = lr, weight_decay
        self.k, self.lr_max, self.weight_sum = 0, 0.0, 0.0

    def point(self) -> dict:
        return {k: B1 * self.x[k] + (1.0 - B1) * self.z[k] for k in self.x}

    @torch.no_grad()
    def update(self, grads: dict, y: dict) -> None:
        k1 = _f32(self.k + 1)
        lr_t = self.lr * torch.sqrt(1.0 - _f32(B2) ** k1)
        lr_max = torch.maximum(_f32(self.lr_max), lr_t)
        weight = k1 ** 0.0 * lr_max ** 2.0
        weight_sum = _f32(self.weight_sum) + weight
        c_t = weight / weight_sum
        c, omc, lr_f = float(c_t), float(1.0 - c_t), float(lr_t)
        for key in self.x:
            g = grads[key]
            self.v[key] = B2 * self.v[key] + (1.0 - B2) * (g * g)
            u = g / (torch.sqrt(self.v[key]) + EPS) + self.wd * y[key]
            self.z[key] = self.z[key] - lr_f * u
            self.x[key] = omc * self.x[key] + c * self.z[key]
        self.k += 1
        self.lr_max, self.weight_sum = float(lr_max), float(weight_sum)


def _cpu(tensors: dict) -> dict:
    return {k: t.detach().float().cpu() for k, t in tensors.items()}


def reference_steps(config: dict, traffic: dict, seed: int, device,
                    arith="f32", steps: int = 3, fault=None,
                    log=None) -> dict:
    """The reference's ``steps`` steps. ``fault`` plants one of the
    check's faults in the reference's place: 'frozen' (the state never
    changes), 'half' (each step on the first half of its batch, the mean
    over it), 'grad' (``FAULT_LEAF``'s gradient doubled where it is
    made), 'lnbias' (``LN_FAULT_LEAF``'s gradient zeroed). ``arith``:
    'f32', 'control', 'tf32' or an ``Arith``."""
    ar = arith if isinstance(arith, Arith) else Arith(arith)
    inp = make_inputs(config, traffic, seed, device)
    t_cfg, s_cfg = config["teacher"], config["student"]
    eps = float(config["norm_eps"])
    gelu = "tanh" if config["precision"]["compute"] == "bfloat16" else "none"
    layers = token_layers(s_cfg["depth"], config["basd"]["num_extraction_points"])
    cap = config["basd"].get("max_rank") or s_cfg["embed_dim"]
    cap = min(int(cap), s_cfg["embed_dim"])
    size, c = config["img_size"], config["num_classes"]
    stats = config["stats"]
    tw = inp["teacher"]
    params = {STUDENT + k: v for k, v in inp["student"].items()}
    params[TEMPS] = inp["log_temperatures"]
    opt = ScheduleFree(params, config["training"]["learning_rate"],
                       config["training"]["weight_decay"])
    x0 = {k: v.clone() for k, v in opt.x.items()}
    g = torch.Generator(device=device).manual_seed(inp["run_seed"])
    b = traffic["batch"]
    out = {"losses": [], "ce": [], "geo": [], "ranks": []}
    for i in range(steps):
        images = inp["images"][i % traffic["pool"]]
        labels = inp["labels"][i % traffic["pool"]]
        if fault == "half":
            images, labels = images[:b // 2], labels[:b // 2]
        draws = views.draw_step(g, images.shape[0], size, s_cfg["depth"],
                                float(s_cfg["drop_path_rate"]), device)
        clean, mixed, targets = views.views(
            draws, images, labels, size, stats["train"], stats["teacher"], c)
        # the models take their images in the configuration's compute type
        clean = clean.to(torch.bfloat16).float()
        mixed = mixed.to(torch.bfloat16).float()
        t_tok, t_imp = model.teacher_forward(ar, tw, clean, t_cfg, eps, gelu)
        y = {k: v.clone().requires_grad_(True) for k, v in opt.point().items()}
        sw = {k[len(STUDENT):]: v for k, v in y.items() if k.startswith(STUDENT)}
        logits, s_tok = model.student_forward(ar, sw, mixed, s_cfg, eps, gelu,
                                              draws, layers)
        loss, parts = ref_loss.basd_loss(
            ar, logits, targets, s_tok, t_tok, t_imp, inp["selector"], y[TEMPS],
            cap, config["label_smoothing"], config["basd"]["spectral_backend"])
        del t_tok, t_imp
        keys = list(y)
        grads = dict(zip(keys, torch.autograd.grad(loss, [y[k] for k in keys])))
        del logits, s_tok
        if fault == "grad":
            grads[FAULT_LEAF] = 2.0 * grads[FAULT_LEAF]
        if fault == "lnbias":
            grads[LN_FAULT_LEAF] = torch.zeros_like(grads[LN_FAULT_LEAF])
        if i == 0:
            out["grads"] = _cpu(grads)
            out["grad_norms"] = {k: float(t.double().norm())
                                 for k, t in grads.items()}
        if fault != "frozen":
            opt.update(grads, {k: v.detach() for k, v in y.items()})
        out["losses"].append(float(loss.detach()))
        out["ce"].append(float(parts["ce"]))
        out["geo"].append(float(parts["geo"]))
        out["ranks"].append(parts["ranks"].tolist())
        if log is not None:
            log(f"reference step {i + 1}: loss {out['losses'][-1]} ce "
                f"{out['ce'][-1]} geo {out['geo'][-1]}")
        del grads, y, loss
    y = opt.point()
    out["changes"] = _cpu({k: y[k] - x0[k] for k in y})
    return out
