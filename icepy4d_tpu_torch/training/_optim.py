"""The optimiser pieces the trainers use, written to reproduce the optax
transforms of the JAX package to float32 rounding (optax is a JAX
library; the port does not import it):

  SuperPoint: adam(lr)
  LightGlue:  chain(clip_by_global_norm(1.0),
                    adam(warmup_cosine_decay_schedule(0, lr, warmup,
                                                      max(steps, warmup + 1),
                                                      0.05 * lr)))
  ALIKED:     chain(clip_by_global_norm(1.0),
                    adamw(cosine_decay_schedule(lr, steps)))

What differs from `torch.optim`: the schedule is read at the update
count before its increment (LightGlue's first update runs at lr 0);
the moments are `(1 - b) * g + b * m` and the step
`m_hat / (sqrt(v_hat) + eps)`; adamw decays by 1e-4 (optax's default)
as `u + wd * p` before the learning rate scales it; the clip scales by
`max_norm / norm` only when the norm is not below `max_norm` (no
`+ 1e-6`), and leaves the caller's gradients as they are.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def constant_schedule(value: float) -> Callable[[int], float]:
    return lambda count: value


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """Linear warmup from init_value to peak_value over warmup_steps,
    then cosine decay to end_value at decay_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """New tensors: grads divided by norm / max_norm where their global
    L2 norm is not below max_norm, unchanged otherwise. No host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    divisor = torch.where(norm < max_norm, 1.0, norm / max_norm)
    return torch._foreach_div(grads, divisor)


class Adam:
    """optax's adam / adamw, optionally behind clip_by_global_norm, over
    a list of parameters updated in place by `step()` from their
    `.grad`.

    lr: a float or a schedule, a function of the update count before
    its increment. weight_decay > 0 is adamw (optax's default 1e-4 is
    the caller's to pass).
    """

    def __init__(self, params, lr, *, clip_norm: float | None = None,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr if callable(lr) else constant_schedule(float(lr))
        self.clip_norm = clip_norm
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        # m = (1 - b1) g + b1 m;  v = (1 - b2) g^2 + b2 v
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        lr = self.lr(self.count)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        updates = torch._foreach_div(mu_hat, nu_hat)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(
                self.params, self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)


def superpoint_optimizer(params, lr: float) -> Adam:
    """adam(lr), SuperPoint's."""
    return Adam(params, lr)


def lightglue_optimizer(params, lr: float, steps: int, warmup: int) -> Adam:
    """LightGlue's: the clip at 1.0, then adam with a warmup from 0 to lr
    over `warmup` updates and a cosine decay to 0.05 lr at
    max(steps, warmup + 1)."""
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup,
                                         max(steps, warmup + 1), lr * 0.05)
    return Adam(params, sched, clip_norm=1.0)


def aliked_optimizer(params, lr: float, steps: int) -> Adam:
    """ALIKED's: the clip at 1.0, then adamw (decay 1e-4) with lr
    cosine-decayed to 0 over `steps`."""
    return Adam(params, cosine_decay_schedule(lr, steps), clip_norm=1.0,
                weight_decay=1e-4)
