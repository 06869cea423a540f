"""LR schedules: constant, cosine, and WSD (Warmup-Stable-Decay, MiniCPM
arXiv:2404.06395 — the schedule of the minicpm-2b arch).

Each schedule takes the optimizer's step (an int tensor) and returns an
f32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def f(step):
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return f


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)
    return f


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.1):
    """Warmup -> Stable plateau -> exponential-ish Decay (MiniCPM section 4).

    The decay phase multiplies down to floor_frac * peak over `decay` steps.
    """
    floor = peak_lr * floor_frac

    def f(step):
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak_lr * torch.pow(floor / peak_lr, t)
        out = torch.where(s < warmup, warm,
                          torch.where(s < warmup + stable, torch.full_like(s, peak_lr), dec))
        return torch.clamp_min(out, 0.0)
    return f
