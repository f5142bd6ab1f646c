"""Learning-rate schedules — port of ``repro.train.schedule``.

Each schedule is a function of the step: a tensor (or an int, taken as a
CPU tensor), evaluated in float32 on that tensor's device, as ``jnp``
evaluates the reference's.  A Python scalar in the formula meets a
float32 tensor and is rounded to float32 there, as a weakly typed scalar
is in JAX; evaluating the formula in Python floats (float64) instead would
put the learning rate about one ulp off the reference's.  A division by a
Python scalar goes through ``scalar_div``: PyTorch computes
``scalar / tensor`` as a reciprocal times the scalar, and on the card
``tensor / scalar`` as the tensor times the scalar's reciprocal, each a
second rounding the reference does not make.  ``sqrt`` and ``cos`` are
taken in float64 and rounded once to float32 (``_f32_of``): XLA's float32
sqrt is correctly rounded and PyTorch's CPU one is not (130 of 20,000
arguments off by an ulp), and XLA's float32 cos is itself within an ulp
of the correctly rounded value, which PyTorch's float32 cos misses more
often (4,937 against 1,366 of 100,001 arguments of the cosine schedule).
"""
from __future__ import annotations

import dataclasses
import math

import torch


def scalar_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded on every device: d is made a tensor of x's
    dtype on x's device, so the division is tensor by tensor."""
    return x / torch.full_like(x, d)


def _f32_of(fn, x: torch.Tensor) -> torch.Tensor:
    """fn of a float32 tensor, taken in float64 and rounded once."""
    return fn(x.to(torch.float64)).to(torch.float32)


def _step32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class CosineSchedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    final_frac: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        s = _step32(step)
        warm = scalar_div(self.peak_lr * s, max(self.warmup_steps, 1))
        prog = torch.clamp(
            scalar_div(s - self.warmup_steps,
                       max(self.total_steps - self.warmup_steps, 1)),
            0.0, 1.0)
        cos = self.final_frac + (1 - self.final_frac) * 0.5 * (
            1.0 + _f32_of(torch.cos, math.pi * prog))
        return torch.where(s < self.warmup_steps, warm, self.peak_lr * cos)


@dataclasses.dataclass(frozen=True)
class ConstantSchedule:
    lr: float = 1e-3

    def __call__(self, step) -> torch.Tensor:
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(self.lr, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class RsqrtSchedule:
    peak_lr: float = 1e-2
    warmup_steps: int = 1000

    def __call__(self, step) -> torch.Tensor:
        s = _step32(step) + 1.0
        w = float(self.warmup_steps)
        return self.peak_lr * torch.minimum(
            scalar_div(s, w), _f32_of(torch.sqrt, torch.full_like(s, w) / s))
