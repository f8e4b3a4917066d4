"""Learning-rate schedules — the counterparts of ``repro.optim.schedules``:
functions of the f32 step tensor (1 at the first update)."""

import math

import torch


def constant(value):
    return lambda step: torch.full_like(step, value, dtype=torch.float32)


def cosine_decay(peak, total_steps, floor=0.0):
    def fn(step):
        frac = torch.clamp(step / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))

    return fn


def linear_warmup_cosine(peak, warmup_steps, total_steps, floor=0.0):
    cos = cosine_decay(peak, max(total_steps - warmup_steps, 1), floor)

    def fn(step):
        warm = peak * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
