"""AdamW with decoupled weight decay, global-norm clipping and f32 state:
the port of ``repro.optim.adamw``.

The state matches the parameter tree leaf for leaf (m and v in float32)
plus an int32 step counter.  Unlike the reference, which returns new
trees, ``update`` writes the parameters and the moments in place, leaf by
leaf under ``torch.no_grad()``: the peak stays at parameters + gradients +
the two moments + a few temporaries of one leaf, where a functional copy
of every tree would add a full set of each.  The arithmetic and its order
are the reference's: the global norm in f32, the clip scale, then per leaf
m and v in f32, the bias corrections ``1 - b**step`` in f32, decoupled
decay on leaves of two or more dims whose key holds neither ``ln`` nor
``norm``, and the new value cast back to the parameter's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import flatten, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_state(params: dict) -> dict:
    """Zero f32 moments under the parameters' keys and a step of 0 on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = flatten(params)[0][1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, on
    the first leaf's device (the leaves may lie on several)."""
    sums = [x.float().square().sum() for _, x in flatten(tree)]
    return torch.stack([s.to(sums[0].device) for s in sums]).sum().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple:
    """(f32 grads scaled to a global norm of at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _decay_mask(path: tuple) -> bool:
    """No weight decay on norms (keys holding ``ln`` or ``norm``)."""
    name = path[-1]
    return "ln" not in name and "norm" not in name


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, lr,
           cfg: AdamWConfig = AdamWConfig()) -> tuple:
    """One AdamW step, in place on ``params`` and ``state``.  ``lr`` is a
    float or an f32 scalar tensor.  The leaves may lie on several devices
    (a pipeline's stages), each with its moments on its own device.
    Returns (params, state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    state["step"] += 1
    step = state["step"].float()
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    grad_leaves = dict(flatten(grads))
    m_leaves, v_leaves = dict(flatten(state["m"])), dict(flatten(state["v"]))
    scalars: dict = {}
    for path, p in flatten(params):
        if p.device not in scalars:   # the step's scalars on p's device
            scalars[p.device] = [t.to(p.device)
                                 for t in (scale, b1c, b2c, lr)]
        scale_p, b1c_p, b2c_p, lr_p = scalars[p.device]
        g = grad_leaves[path].float() * scale_p
        m, v = m_leaves[path], v_leaves[path]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        del g
        den = (v / b2c_p).sqrt_().add_(cfg.eps)
        upd = (m / b1c_p).div_(den)
        del den
        if cfg.weight_decay and p.dim() >= 2 and _decay_mask(path):
            upd.add_(cfg.weight_decay * p.float())
        p.copy_(p.float().sub_(upd.mul_(lr_p)))
    return params, state, {"grad_norm": gnorm, "lr": lr}
