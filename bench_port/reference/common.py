"""What every model's plain reference shares: the precision of the matrix
products (float32 with TF32 off; float8 for the control; bfloat16 as a
witness), the benchmark's weights from the seed, the learning-rate
schedules and the AdamW update of the published trainer, and the CER.
Imports nothing of the port.

``precision="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 (per-tensor scale) and its output gradient to e5m2,
the step below the configurations' bfloat16 autocast. ``precision="bf16"``
rounds the same operands, outputs and gradients to bfloat16, as the
autocast does: a witness of what bfloat16's rounding alone moves.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------- precision

class _Fp8Operand(torch.autograd.Function):
    """Forward: ``x`` rounded to float8 e4m3 at a per-tensor scale; backward:
    the gradient as it comes (straight through)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: identity; backward: the gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


class _Bf16Round(torch.autograd.Function):
    """Forward and backward: the value rounded to bfloat16 and back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype) * scale).to(x.dtype)


class Precision:
    """Matrix products in float32, with float8 operands (the control), or
    with bfloat16 operands, outputs and gradients (a witness)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16":
            return _Bf16Round.apply(x)
        return _Fp8Operand.apply(x) if self.name == "fp8" else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16":
            return _Bf16Round.apply(y)
        return _Fp8Grad.apply(y) if self.name == "fp8" else y

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.out(torch.matmul(self.operand(a), self.operand(b)))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        y = torch.matmul(self.operand(x), self.operand(w).t())
        y = self.out(y)
        return y if b is None else y + b


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ weights

def weight_seed(seed: int) -> int:
    """The weights' generator seed: a function of the run's seed that is not
    the trainer's seed (whose stream draws dropout and noise)."""
    return int(np.random.SeedSequence((int(seed), 0x5EED)).generate_state(1)[0])


def make_weights(spec: Sequence[Tuple[str, tuple]], seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights: one uniform draw on ``device`` cut into the
    leaves. A matrix is uniform in +-1/sqrt(fan_in), a norm's gain 1 +- 0.1,
    every other vector +-0.02."""
    gen = torch.Generator(device).manual_seed(weight_seed(seed))
    total = sum(math.prod(shape) for _, shape in spec)
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        x = u[off:off + n].view(shape)
        off += n
        if len(shape) == 2:
            x = x / math.sqrt(shape[1])
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.02 * x
        out[name] = x.contiguous()
    return out


# -------------------------------------------------------- optimizer, schedule

def _onecycle(total: int, peak: float, pct: float, div: float, final_div: float):
    bounds = [0, int(pct * total), int(total)]
    values = [peak / div, peak, peak / div / final_div]

    def sched(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                frac = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1)
        return values[2] if count >= bounds[2] else 0.0

    return sched


def learning_rate(opt: Dict, steps_per_epoch: int, num_epochs: int, count: int) -> float:
    """The learning rate of update ``count`` (0-based): the published
    trainer's OneCycle (``cosine``), ``linear`` or ``step`` schedule."""
    gas = int(opt.get("gradient_accumulation_steps", 1) or 1)
    if gas != 1:
        raise NotImplementedError("reference: gradient accumulation")
    total_updates = max(1, num_epochs * steps_per_epoch)
    lr = float(opt["lr"])
    name = opt.get("scheduler", "step")
    if name == "cosine":
        total = max(total_updates, 2)
        pct = min(max(float(opt.get("warmup_pct", 0.3)), 1.0 / total), 1.0 - 1.0 / total)
        return _onecycle(total, lr, pct, float(opt.get("div_factor", 25)), 1e4)(count)
    if name == "step":
        return lr * float(opt.get("gamma", 0.95)) ** (count // max(1, steps_per_epoch))
    if name == "linear":
        warmup = round(float(opt.get("warmup_pct", 0.0)) * total_updates)
        if warmup == 0:
            return lr * (1.0 - min(count, total_updates) / total_updates)
        if count < warmup:
            return lr * min(count, warmup) / warmup
        down = max(total_updates - warmup, 1)
        return lr * (1.0 - min(count - warmup, down) / down)
    raise ValueError(f"scheduler {name!r}")


class AdamW:
    """``torch.optim.AdamW`` (betas 0.9 / 0.999) written out: decoupled decay
    ``p *= 1 - lr * wd``, bias-corrected moments, ``eps`` outside the root."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: float, eps: float,
                 betas=(0.9, 0.999)):
        self.wd, self.eps, self.betas = wd, eps, betas
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


# --------------------------------------------------------------- CER metric

def greedy_ids(frame_ids: Sequence[int], blank: int = 0) -> List[int]:
    """CTC's greedy collapse: repeats merged, blanks dropped."""
    out, last = [], -1
    for i in frame_ids:
        i = int(i)
        if i != last and i != blank:
            out.append(i)
        last = i
    return out


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


def cer(frame_ids: np.ndarray, targets: Sequence[Sequence[int]], blank: int = 0) -> float:
    """Phoneme error rate of a batch: summed edit distances of the greedy
    decodes against the targets, over the targets' summed lengths."""
    errors = sum(edit_distance(greedy_ids(row, blank), list(t))
                 for row, t in zip(frame_ids, targets))
    return errors / sum(len(t) for t in targets)
