"""Learning-rate schedules in float32: linear warmup then cosine, WSD
(warmup-stable-decay, MiniCPM arXiv:2404.06395) and constant; the port of
``repro.optim.schedules``.  Each factory returns ``lr(step)``, a 0-d
float32 tensor on the step's device (the CPU for a Python int)."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, base_lr * cos)
    return lr


def wsd(base_lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup -> stable (flat) -> exponential decay over the last
    ``decay_frac`` of the steps."""
    decay_start = int(total_steps * (1.0 - decay_frac))

    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        dec = base_lr * torch.pow(final_frac, prog)
        flat = torch.where(step >= decay_start, dec,
                           torch.full_like(step, base_lr))
        return torch.where(step < warmup_steps, warm, flat)
    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.tensor(base_lr, dtype=torch.float32)
    return lr


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd}
