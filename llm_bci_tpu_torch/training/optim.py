"""AdamW and the learning-rate schedules (counterpart of
``llm_bci_tpu/training/optim.py``).

``build_schedule`` returns a plain function of the update count whose
value equals the optax schedule the JAX package builds, step for step:

* ``linear`` — linear warmup then linear decay to 0
  (``optax.linear_schedule`` / ``join_schedules``); with no warmup it starts
  at the full rate;
* ``cosine`` — OneCycle, ``optax.cosine_onecycle_schedule`` with
  ``div_factor`` and ``final_div_factor=1e4``, its phases clamped to at
  least one step each;
* ``step`` — ``lr * gamma ** (count // updates_per_epoch)``.

The trainer sets ``param_group["lr"] = schedule(count)`` before each
update of ``torch.optim.AdamW``, which then equals ``optax.adamw`` (the
decoupled decay ``-lr * wd * p`` and the bias-corrected moments with
``eps`` outside the square root). Gradient accumulation follows
``optax.MultiSteps``: ``gradient_accumulation_steps`` micro-batches are
averaged into one update, and the schedule counts updates.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch


def _polynomial(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule(init, end, steps)``."""
    if steps <= 0:
        return lambda count: init

    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _onecycle(total: int, peak: float, pct: float, div: float,
              final_div: float) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``: a piecewise cosine interpolation
    through init = peak/div, peak, and init/final_div."""
    bounds = [0, int(pct * total), int(total)]
    values = [peak / div, peak, peak / div / final_div]

    def sched(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct_i = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct_i) + 1)
        return values[2] if count >= bounds[2] else 0.0

    return sched


def build_schedule(opt_cfg, steps_per_epoch: int, num_epochs: int
                   ) -> Tuple[Callable[[int], float], int]:
    """Returns ``(schedule_fn, total_updates)``; ``steps_per_epoch`` counts
    dataloader iterations, updates divide them by the accumulation."""
    gas = int(opt_cfg.get("gradient_accumulation_steps", 1) or 1)
    total_updates = max(1, num_epochs * steps_per_epoch // gas)
    lr = float(opt_cfg["lr"])
    name = opt_cfg.get("scheduler", "step")

    if name == "linear":
        warmup = round(float(opt_cfg.get("warmup_pct", 0.0)) * total_updates)
        if warmup == 0:
            return _polynomial(lr, 0.0, total_updates), total_updates
        up = _polynomial(0.0, lr, warmup)
        down = _polynomial(lr, 0.0, max(total_updates - warmup, 1))
        return (lambda c: up(c) if c < warmup else down(c - warmup)), total_updates
    if name == "cosine":
        total = max(total_updates, 2)
        pct = float(opt_cfg.get("warmup_pct", 0.3))
        pct = min(max(pct, 1.0 / total), 1.0 - 1.0 / total)
        div = float(opt_cfg.get("div_factor", 25))
        return _onecycle(total, lr, pct, div, 1e4), total_updates
    if name == "step":
        updates_per_epoch = max(1, steps_per_epoch // gas)
        gamma = float(opt_cfg.get("gamma", 0.95))
        return (lambda c: lr * gamma ** (c // updates_per_epoch)), total_updates
    raise ValueError(f"Scheduler {name!r} not implemented")


def build_optimizer(params: Iterable[torch.nn.Parameter], opt_cfg, steps_per_epoch: int,
                    num_epochs: int) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    schedule, _ = build_schedule(opt_cfg, steps_per_epoch, num_epochs)
    opt = torch.optim.AdamW(
        params,
        lr=schedule(0),
        weight_decay=float(opt_cfg.get("wd", 0.01)),
        eps=float(opt_cfg.get("eps", 1e-8)),
    )
    return opt, schedule
