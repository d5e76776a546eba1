"""Learning-rate schedules, the counterpart of ``repro/training/schedule.py``.

``step`` is an int or a tensor; the arithmetic is fp32, as the
reference's, and each schedule returns a 0-d fp32 tensor.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = peak_lr * s / max(warmup, 1)
    frac = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)


def warmup_invsqrt(step, *, peak_lr: float, warmup: int) -> torch.Tensor:
    s = _f32(step).clamp(min=1.0)
    warm = peak_lr * s / max(warmup, 1)
    decay = peak_lr * torch.sqrt(warmup / s)
    return torch.where(s < warmup, warm, decay)


def constant(step, *, peak_lr: float, warmup: int = 0) -> torch.Tensor:
    s = _f32(step)
    if warmup:
        return torch.minimum(torch.tensor(peak_lr), peak_lr * s / warmup)
    return torch.full_like(s, peak_lr)
