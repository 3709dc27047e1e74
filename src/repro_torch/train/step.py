"""Train-step factory: loss, gradients and the AdamW update on one card;
the port of ``repro.train.step``.

``make_train_step`` returns ``(train_step, loss_fn)``.
``train_step(params, opt_state, batch, step)`` takes the gradient of
``loss_fn`` with autograd through the plain layers (``impl="plain"``, the
counterpart of the reference's ``"chunked"``: no kernel of either package
has a backward) and updates ``params`` and ``opt_state`` in place
(``optim.adamw.update``).  The loss is the reference's: the cross entropy
of the token rows (a modality-frontend arch's projected rows dropped) plus
the MoE layers' router aux losses.  The reference's ``shard_fn`` and
``grad_constraint`` are multi-device and wait for ROADMAP queue 1 item 6.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.tree import flatten, unflatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy, as the reference computes it: the max
    shift (no gradient through it), the f32 log-sum-exp, and the gold
    logit taken by an iota compare, not a gather."""
    V = logits.shape[-1]
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = (logits - lmax).float()
    lmax_f = lmax[..., 0].float()
    logz = torch.log(torch.exp(shifted).sum(dim=-1)) + lmax_f
    onehot = labels[..., None] == torch.arange(V, dtype=labels.dtype,
                                               device=labels.device)
    gold = torch.where(onehot, shifted, 0.0).sum(dim=-1) + lmax_f
    return (logz - gold).mean()


@dataclass(frozen=True)
class TrainStepConfig:
    impl: str = "plain"
    n_groups: int = 1              # MoE dispatch groups
    capacity_factor: float = 1.25  # MoE capacity per expert
    grad_accum: int = 1
    remat: Optional[bool] = None   # per-repeat rematerialisation; None = on
    adamw: AdamWConfig = field(default_factory=AdamWConfig)


@contextmanager
def _requiring_grad(leaves: list):
    """Mark the parameter leaves as requiring grad for the step, and put
    their flags back after, so that trained parameters can be served."""
    flags = [t.requires_grad for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t, flag in zip(leaves, flags):
            t.requires_grad_(flag)


def value_and_grad(loss_fn: Callable, params: dict, batch: dict, *,
                   allow_unused: bool = False) -> tuple:
    """(loss, metrics, gradients) of ``loss_fn(params, batch)``; the
    gradients are a list in ``flatten(params)`` order, each in its
    parameter's dtype.  A leaf the loss never reads raises, or with
    ``allow_unused`` gets a zero gradient, as under ``jax.value_and_grad``
    (the pipeline's loss reads no frontend projection).  The parameters'
    ``requires_grad`` flags are as they were after the call."""
    leaves = [t for _, t in flatten(params)]
    with torch.enable_grad(), _requiring_grad(leaves):
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=allow_unused,
                                    materialize_grads=allow_unused)
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, lr_fn: Callable,
                    tcfg: TrainStepConfig = TrainStepConfig()):
    F = cfg.prepended_rows

    def loss_fn(params: dict, batch: dict) -> tuple:
        logits, _, aux = lm.forward(
            cfg, params, batch["tokens"],
            frontend_emb=batch.get("frontend_emb"), mode="train",
            impl=tcfg.impl, remat=tcfg.remat, n_groups=tcfg.n_groups,
            capacity_factor=tcfg.capacity_factor)
        ce = cross_entropy(logits[:, F:] if F else logits, batch["labels"])
        return ce + aux, {"ce": ce.detach(), "aux": aux.detach()}

    def train_step(params: dict, opt_state: dict, batch: dict,
                   step) -> tuple:
        """One step, in place on ``params`` and ``opt_state``; returns
        (params, opt_state, metrics).  ``batch``: {"tokens", "labels"}
        [B, S] int tensors on the parameters' device, and for a frontend
        or enc-dec arch "frontend_emb" [B, F, frontend_dim].  With
        ``grad_accum`` n > 1 the batch (each of its tensors along its
        first dim) splits into n contiguous microbatches whose f32
        gradients are summed, divided by n and cast to each parameter's
        dtype; the loss is the mean over microbatches and the other
        metrics are the last microbatch's, as in the reference's scan."""
        n = tcfg.grad_accum
        if n > 1:
            B = batch["tokens"].shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not split into "
                                 f"{n} microbatches")
            b = B // n
            acc, loss = None, 0.0
            for i in range(n):
                micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                l, metrics, grads = value_and_grad(loss_fn, params, micro)
                if acc is None:
                    acc = [g.float() for g in grads]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                loss = loss + l
                del grads
            grads = [(a / n).to(p.dtype)
                     for a, (_, p) in zip(acc, flatten(params))]
            del acc
            loss = loss / n
        else:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        grads = unflatten(zip((path for path, _ in flatten(params)),
                              grads))
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             lr_fn(step), tcfg.adamw)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step, loss_fn
