"""LR schedules (counterpart of ``repro/optim/schedule.py``)."""
import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a float32
    tensor: linear warm-up, then a cosine down to ``min_frac`` of the
    peak, held there past ``total``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp_max(s / max(warmup, 1), 1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, peak_lr * cos)
