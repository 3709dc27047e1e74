"""Pipeline-parallel training over a list of stage devices: the port of
``repro.train.pipeline``.

The reference realises the pipeline as one SPMD program: ``shard_map`` over
a ``(data, model)`` mesh, each stage a device of the ``model`` axis, and
``ppermute`` between stages.  The port is one controller over a list of
stage devices: layers split evenly over the stages, activations cross a
stage boundary by ``.to(next_device)``, and autograd carries the gradients
back through those copies.  The same program runs with its stages on
distinct cards and with several stages on one card (or on the CPU).

Schedule: GPipe with M microbatches over M + S - 1 ticks; at tick t, stage
s computes microbatch t - s.  The reference computes the bubbles and masks
them out; the port skips them.  Stage 0 embeds; each layer is
rematerialised in the backward pass (``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint``); the last stage runs the final norm, the
unembedding and the reference's pipeline loss: the f32 log-sum-exp of the
logits minus the gold logit, summed over the tokens and divided by their
count.  Like the reference's pipeline, and unlike its one-card train step,
that loss masks no padded vocabulary ids, drops the MoE router aux loss
and ignores a modality frontend's rows (ROADMAP F12).

Scope, as the reference's: one segment with a one-layer cycle of global or
sliding-window attention with a dense or MoE FFN, ``n_layers`` a multiple
of the stage count.  The reference's data axis (one pipeline per data
replica) is not ported yet (ROADMAP queue 1 item 6).

Parameters: ``split_stage_params`` turns an ``lm.init_params`` tree into
the pipeline's tree, ``join_stage_params`` turns it (or a gradient or
moment tree of the same layout) back.  The pipeline's tree keeps every
top-level leaf but ``seg0`` (``embed``, ``final_norm``, ``unembed``, a
frontend projection) on stage 0's device, and holds stage s's slice of the
stacked layer leaves under ``stage{s}`` on stage s's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks, lm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.tree import flatten, tree_map, unflatten

from .step import value_and_grad

STAGE = "stage{}"


def pipeline_refusal(cfg: ModelConfig, n_stages: int) -> Optional[str]:
    """Why the pipeline does not take ``cfg`` over ``n_stages`` stages, or
    None when it does."""
    segs = cfg.segments()
    if len(segs) != 1 or len(segs[0].cycle) != 1:
        return (f"{cfg.name}: the pipeline takes one segment with a "
                f"one-layer cycle, as the reference's assertion does "
                f"(src/repro/train/pipeline.py:52-54); this config has "
                f"{len(segs)} segment(s), the first a cycle of "
                f"{len(segs[0].cycle)}")
    spec = segs[0].cycle[0]
    if spec.mixer not in ("global", "local"):
        return (f"{cfg.name}: the pipeline's layer body is attention "
                f"(global or local) with a dense or MoE FFN; the "
                f"reference's _layer_fwd reads p['attn'] and fails on a "
                f"{spec.mixer!r} layer")
    if cfg.n_enc_layers:
        return (f"{cfg.name}: the pipeline's layer body has no encoder and "
                "no cross attention: the reference's would train another "
                "model")
    if cfg.n_layers % n_stages:
        return (f"{cfg.name}: {cfg.n_layers} layers do not split evenly "
                f"over {n_stages} stages")
    return None


def _devices(stage_devices: Sequence) -> list:
    devices = [resolve_device(d) for d in stage_devices]
    if not devices:
        raise ValueError("the pipeline needs at least one stage device")
    return devices


def split_stage_params(cfg: ModelConfig, params: dict,
                       stage_devices: Sequence) -> dict:
    """An ``lm.init_params`` tree -> the pipeline's tree over
    ``stage_devices`` (copies: the caller's tree is left as it is)."""
    devices = _devices(stage_devices)
    reason = pipeline_refusal(cfg, len(devices))
    if reason:
        raise ValueError(reason)
    per = cfg.n_layers // len(devices)
    out = {k: v.to(devices[0], copy=True) for k, v in params.items()
           if k != "seg0"}
    for s, dev in enumerate(devices):
        out[STAGE.format(s)] = tree_map(
            lambda t: t[s * per:(s + 1) * per].to(dev, copy=True),
            params["seg0"]["c0"])
    return out


def join_stage_params(tree: dict) -> dict:
    """The pipeline's tree (parameters, gradients or AdamW moments) -> the
    one-card layout, every leaf on stage 0's device."""
    n = sum(1 for k in tree if k.startswith("stage"))
    stages = [tree[STAGE.format(s)] for s in range(n)]
    device = flatten(stages[0])[0][1].device
    out = {k: v.to(device) for k, v in tree.items()
           if not k.startswith("stage")}
    out["seg0"] = {"c0": tree_map(
        lambda *ts: torch.cat([t.to(device) for t in ts]), *stages)}
    return out


def _layer_fwd(cfg: ModelConfig, spec: LayerSpec, p: dict, x, positions):
    """One layer (attention or local attention, then the dense or MoE FFN
    in one dispatch group, its aux loss dropped), as the reference's
    ``_layer_fwd``."""
    x, _ = blocks.attn_layer(cfg, p["attn"], x, local=spec.mixer == "local",
                             positions=positions, impl="plain")
    if spec.ffn == "dense":
        x = blocks.ffn_layer(cfg, p["ffn"], x)
    elif spec.ffn == "moe":
        x, _ = blocks.moe_layer(cfg, p["moe"], x, n_groups=1)
    return x


def make_pipeline_train_step(cfg: ModelConfig, stage_devices: Sequence, *,
                             n_microbatches: int = 8,
                             lr_fn: Optional[Callable] = None,
                             adamw_cfg: AdamWConfig = AdamWConfig()):
    """Returns (train_step, loss_fn) over ``stage_devices`` (one entry per
    stage; repeat a device to put several stages on it; None is the CUDA
    card).

    ``loss_fn(params, batch) -> (loss, {})`` on the pipeline's tree (from
    ``split_stage_params``); ``batch``: {"tokens", "labels"} [B, S] int
    tensors on any device, B a multiple of ``n_microbatches``; other keys
    are ignored.  ``train_step(params, opt_state, batch, step)`` takes the
    gradient of ``loss_fn`` and makes the port's in-place AdamW update
    (``optim.init_state`` of the pipeline's tree; lr ``lr_fn(step)``, or
    1e-4 without ``lr_fn``); returns (params, opt_state, {"loss",
    "grad_norm", "lr"}).  Raises ``ValueError`` with the reason for a
    config the pipeline does not take (``pipeline_refusal``)."""
    devices = _devices(stage_devices)
    n_stages = len(devices)
    reason = pipeline_refusal(cfg, n_stages)
    if reason:
        raise ValueError(reason)
    spec = cfg.segments()[0].cycle[0]
    per = cfg.n_layers // n_stages
    M = n_microbatches

    def run_stage(p: dict, x, positions):
        for r in range(per):
            layer = tree_map(lambda t: t[r], p)
            x = checkpoint(_layer_fwd, cfg, spec, layer, x, positions,
                           use_reentrant=False, preserve_rng_state=False)
        return x

    def loss_fn(params: dict, batch: dict) -> tuple:
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             "microbatches")
        mb = B // M
        first, last = devices[0], devices[-1]
        positions = [torch.arange(S, dtype=torch.int32, device=d)
                     for d in devices]
        stage_p = [params[STAGE.format(s)] for s in range(n_stages)]
        final_norm = params["final_norm"].to(last)
        unembed = (params["embed"].T if cfg.tie_embeddings
                   else params["unembed"]).to(last)
        in_flight, loss_sum = {}, None
        for t in range(M + n_stages - 1):
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < M:           # a bubble: nothing to run
                    continue
                if s == 0:
                    x = lm.embed_tokens(
                        cfg, params, tokens[m * mb:(m + 1) * mb].to(first))
                    x = x.to(params["final_norm"].dtype)
                else:
                    x = in_flight.pop(m).to(devices[s])
                y = run_stage(stage_p[s], x, positions[s])
                if s < n_stages - 1:
                    in_flight[m] = y
                    continue
                h = blocks.rms_norm(y, final_norm, cfg.norm_eps)
                logits = (h @ unembed.to(h.dtype)).float()
                lab = labels[m * mb:(m + 1) * mb].to(last).long()
                gold = logits.gather(-1, lab[..., None])[..., 0]
                ce = (torch.logsumexp(logits, dim=-1) - gold).sum()
                loss_sum = ce if loss_sum is None else loss_sum + ce
        return loss_sum / labels.numel(), {}

    def train_step(params: dict, opt_state: dict, batch: dict,
                   step) -> tuple:
        # a leaf the pipeline never reads (a frontend projection) has a
        # zero gradient, as under the reference's value_and_grad
        loss, _, grads = value_and_grad(loss_fn, params, batch,
                                        allow_unused=True)
        grads = unflatten(zip((path for path, _ in flatten(params)),
                              grads))
        lr = lr_fn(step) if lr_fn else 1e-4
        params, opt_state, om = adamw.update(params, grads, opt_state, lr,
                                             adamw_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step, loss_fn
