"""Optimizers and the one-cycle schedule (port of
dfu3d_tpu/train/optimization.py:19-99, itself the reference's
tools/train_utils/optimization).

`adam_onecycle`, the DFU3D recipe (LR 0.001, WEIGHT_DECAY 0.01, MOMS
[0.95, 0.85], PCT_START 0.4, DIV_FACTOR 10, GRAD_NORM_CLIP 10), is AdamW
with b2 from BETAS (default 0.99) whose lr and b1 follow fastai's one cycle:
lr cosine-anneals lr_max / div → lr_max over the first pct_start of the
steps, then → lr_max / div / 1e4; b1 anneals moms[0] → moms[1] and back.
`adam` and `sgd` add the weight decay to the gradient (optax
add_decayed_weights before adam / sgd with momentum).

The JAX package chains optax transformations; here `Optimizer` wraps the
torch optimizer and does what the chain does around it, in its order: the
global-norm clip in optax's form (`clip_by_global_norm`: grads / norm ·
clip where norm >= clip; torch's clip_grad_norm_ adds 1e-6 to the norm),
then the step with lr and b1 read at the count of updates made so far, as
`optax.inject_hyperparams` reads them (the first step runs at lr_max / div).
Every parameter is updated, one with no gradient as if its gradient were 0
(optax adamw has no mask, so its weight decay reaches every leaf).
"""
from __future__ import annotations

import math

import torch


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _pcts(step, pct_start, total_steps):
    a1 = pct_start * total_steps
    pct1 = min(max(step / max(a1, 1.0), 0.0), 1.0)
    pct2 = min(max((step - a1) / max(total_steps - a1, 1.0), 0.0), 1.0)
    return step < a1, pct1, pct2


def onecycle_lr_fn(lr_max, div_factor, pct_start, total_steps):
    low_lr = lr_max / div_factor

    def fn(step):
        first, pct1, pct2 = _pcts(step, pct_start, total_steps)
        return (_annealing_cos(low_lr, lr_max, pct1) if first
                else _annealing_cos(lr_max, low_lr / 1e4, pct2))

    return fn


def onecycle_mom_fn(moms, pct_start, total_steps):
    def fn(step):
        first, pct1, pct2 = _pcts(step, pct_start, total_steps)
        return (_annealing_cos(moms[0], moms[1], pct1) if first
                else _annealing_cos(moms[1], moms[0], pct2))

    return fn


def global_norm(tensors):
    """sqrt(Σ ||t||²) over all tensors, as a 0-dim tensor (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """A torch optimizer stepped as the JAX package's optax chain: clip, then
    the update at the scheduled lr (and b1). `count` is the number of updates
    made, optax's step count."""

    def __init__(self, opt: torch.optim.Optimizer, lr_fn, mom_fn=None, clip: float = 0.0):
        self.opt = opt
        self.lr_fn = lr_fn
        self.mom_fn = mom_fn
        self.clip = float(clip)
        self.count = 0
        self.params = [p for group in opt.param_groups for p in group["params"]]

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        """Clip and update from the parameters' .grad. Returns the global norm
        of the gradients before the clip (a 0-dim tensor on their device)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.clip > 0:
            # optax: where(norm < clip, g, g / norm * clip), with no host sync
            keep = norm < self.clip
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clip).to(norm.dtype))
        for group in self.opt.param_groups:
            group["lr"] = self.lr_fn(self.count)
            if self.mom_fn is not None:
                group["betas"] = (self.mom_fn(self.count), group["betas"][1])
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self):
        return {"optimizer": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.opt.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def build_optimizer(params, optim_cfg, total_steps: int) -> Optimizer:
    """The Optimizer for OPTIMIZATION.OPTIMIZER adam, sgd or adam_onecycle
    over `params`; its `lr_fn` gives the lr at an update count."""
    params = list(params)
    name = optim_cfg.OPTIMIZER
    clip = float(optim_cfg.get("GRAD_NORM_CLIP", 0) or 0)
    wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
    lr = float(optim_cfg.LR)
    mom_fn = None
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=wd)
        lr_fn = lambda step: lr  # noqa: E731
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=float(optim_cfg.get("MOMENTUM", 0.9)),
                              weight_decay=wd)
        lr_fn = lambda step: lr  # noqa: E731
    elif name == "adam_onecycle":
        moms = list(optim_cfg.get("MOMS", [0.95, 0.85]))
        pct_start = float(optim_cfg.get("PCT_START", 0.4))
        lr_fn = onecycle_lr_fn(lr, float(optim_cfg.get("DIV_FACTOR", 10)), pct_start, total_steps)
        mom_fn = onecycle_mom_fn(moms, pct_start, total_steps)
        b2 = float(tuple(optim_cfg.get("BETAS", (0.9, 0.99)))[1])
        opt = torch.optim.AdamW(params, lr=lr_fn(0), betas=(mom_fn(0), b2), weight_decay=wd)
    else:
        raise NotImplementedError(f"optimizer {name} is not ported")
    return Optimizer(opt, lr_fn, mom_fn, clip)
