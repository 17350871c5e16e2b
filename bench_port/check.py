"""What decides ``correct``: the reference follows the timed path's first
steps, and the numbers that compare the two are held to the cell's limits.

The reference (``bench_port/reference``) starts from the benchmark's
weights, takes each checked step's trials (the ``trial`` ids the timed path
trained on) from the raw dataset, makes the same random draws from the
trainer's seed, and takes the AdamW step. Compared:

* ``loss_gap``: the loss of each of the first ``LOSS_STEPS`` steps, the
  widest relative gap;
* ``grad_gap``: the first gradient as the optimizer holds it (its first
  moment after one step over ``1 - beta1``) against the reference's, leaf
  by leaf: the gap between the two norms over the larger of the reference
  leaf's norm and the median leaf's, at the worst leaf;
* ``grad2_gap``: the same of the second step's gradient as the optimizer
  takes it (in a chained cell the first replayed step);
* ``update_gap``: the same of each leaf's change after the checked steps
  (on a few flagship seeds in ten, bfloat16's rounding, compounded by the
  first AdamW steps, moves these two by up to a tenth at a 1024-wide bias
  or norm gain: their limits catch a leaf left unmoved or moved double, and
  the followed step below holds a later step to rounding alone);
* ``cer_gap`` (CTC): the train CER the metric fn gave each checked step
  against the reference's CER of the same greedy frame ids (exact);
* ``followed_loss_gap`` / ``followed_grad_gap``: one later step (the
  traffic's ``follow_step``: in a chained cell a replayed step, in the
  pooled cell one that the device batch pool served), followed from the
  program's parameters just before it, with the generator moved as far as
  the steps before it moved it: the reference cannot follow bfloat16's
  rounding, compounded by AdamW over the steps before, from the start.

Leaves whose reference gradient is under ``ZERO_GRAD`` of the median leaf's
(an attention key's bias, which softmax makes nought) move by round-off
alone and are left out of the gradient and update gaps.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

import reference
from reference import common
from reference import data as ref_data

ZERO_GRAD = 1e-3
# Losses compared: the steps before the first full-rate update. The flagship's
# OneCycle takes its peak rate at update 2, and the loss after it swings from
# seed to seed (Adam's first steps move every element by about the rate,
# whatever its gradient's size, so bfloat16's rounding of a small element's
# sign moves the next loss by up to 2e-2 of itself).
LOSS_STEPS = 2


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= ZERO_GRAD * med]


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], keep: Sequence[str]
              ) -> Dict[str, float]:
    """Each kept leaf's gap between the two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    med = statistics.median(refn[k] for k in keep)
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med) for k in keep}


def worst_leaf_gap(prog: Dict[str, float], refn: Dict[str, float], keep: Sequence[str]) -> float:
    return max(leaf_gaps(prog, refn, keep).values())


def follow(p0: Dict[str, torch.Tensor], trials: Dict[str, List[dict]], steps: Dict[int, List[int]],
           config: Dict, seed: int, device, precision: str = "fp32",
           followed: Optional[dict] = None, half_batch: bool = False, frozen: bool = False
           ) -> dict:
    """The reference's readings of the checked steps ``steps`` ({step: trial
    ids}, steps 1..n in order) from the weights ``p0``: each step's loss and
    gradient norms, and each leaf's change after them; with ``followed``
    ({"step": k, "trials": ids, "params": the program's leaves before step
    k}) also step k's loss and gradient norms. Two faults: ``half_batch``
    trains each step on the first half of its rows with the loss doubled;
    ``frozen`` takes no update (the optimizer then holds no gradient)."""
    ref = reference.model_module(config)
    trainer = config["trainer"]
    model, method = trainer["model"], config["method"]
    rows = {int(r["trial"]): r for split in trials.values() for r in split}
    widths = ref_data.pad_widths(trials)
    side = trainer["method"]["dataloader_kwargs"]["pad_dict"]["spikes"]["side"]
    opt = trainer["optimizer"]
    B = int(trainer["training"]["train_batch_size"])
    steps_per_epoch = -(-int(config["train_trials"]) // B)
    num_epochs = int(trainer["training"]["num_epochs"])
    prec = common.Precision(precision)

    def batch_of(ids):
        ids = list(ids)[:len(ids) // 2] if half_batch else list(ids)
        return ref_data.batch([rows[i] for i in ids], widths, side, device)

    out = {"losses": {}, "grads": {}, "update": None}
    with common.exact_float32():
        params = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
        adam = common.AdamW(params, wd=float(opt["wd"]), eps=float(opt["eps"]))
        gen = torch.Generator(device).manual_seed(int(seed))
        for step in sorted(steps):
            b = batch_of(steps[step])
            loss, _, grads, preds = ref.train_step(params, b, model, method, gen, prec)
            if half_batch:
                loss *= 2.0
                grads = {k: 2.0 * g for k, g in grads.items()}
            out["losses"][step] = loss
            out["grads"][step] = leaf_norms(grads)
            lr = common.learning_rate(opt, steps_per_epoch, num_epochs, step - 1)
            if not frozen:
                adam.step(params, grads, lr)
        out["grad1"] = out["grads"].get(1)
        if frozen:
            out["grad1"] = {k: 0.0 for k in out["grad1"]}
        out["update"] = leaf_norms({k: params[k] - p0[k] for k in params})
        del params, adam
        if followed is not None:
            gen = torch.Generator(device).manual_seed(int(seed))
            shape = (B, widths["bins"], int(next(iter(trials.values()))[0]["spikes"].shape[1]))
            for _ in range(followed["step"] - 1):
                ref.draw_only(model, method, shape, gen, device)
            params = {k: v.to(device).clone().requires_grad_(True)
                      for k, v in followed["params"].items()}
            loss, _, grads, _ = ref.train_step(params, batch_of(followed["trials"]), model, method,
                                               gen, prec)
            out["followed"] = {"loss": loss, "grad": leaf_norms(grads)}
    return out


def reference_cer(ids: np.ndarray, trial_ids: Sequence[int], trials: Dict[str, List[dict]]) -> float:
    rows = {int(r["trial"]): r for split in trials.values() for r in split}
    return common.cer(ids, [rows[int(i)]["phonemes_idx"] for i in trial_ids])


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    """The numbers compared. ``prog`` holds the program's readings in the
    reference's form (``losses``, ``grad1``, ``grads``, ``update``; ``cer`` as
    {step: (program's CER, reference's CER of its ids)}; ``followed``)."""
    nums = {}
    nums["loss_gap"] = max(abs(prog["losses"][s] - refr["losses"][s]) / abs(refr["losses"][s])
                           for s in refr["losses"] if s <= LOSS_STEPS)
    keep = kept_leaves(refr["grad1"])
    nums["grad_gap"] = worst_leaf_gap(prog["grad1"], refr["grad1"], keep)
    if 2 in refr["grads"]:
        nums["grad2_gap"] = worst_leaf_gap(prog["grads"][2], refr["grads"][2],
                                           kept_leaves(refr["grads"][2]))
    nums["update_gap"] = worst_leaf_gap(prog["update"], refr["update"], keep)
    if prog.get("cer"):
        nums["cer_gap"] = float(max(abs(a - b) for a, b in prog["cer"].values()))
    if refr.get("followed") is not None:
        pr, rr = prog["followed"], refr["followed"]
        nums["followed_loss_gap"] = abs(pr["loss"] - rr["loss"]) / abs(rr["loss"])
        nums["followed_grad_gap"] = worst_leaf_gap(pr["grad"], rr["grad"],
                                                   kept_leaves(rr["grad"]))
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in nums.items()}


def details(prog: dict, refr: dict) -> dict:
    """What lies behind the numbers: each step's loss gap, and of the first
    and second gradients, the change and the followed step's gradient the
    three worst leaves and the median leaf's gap."""
    out = {"loss_gaps": [abs(prog["losses"][s] - refr["losses"][s]) / abs(refr["losses"][s])
                         for s in sorted(refr["losses"])]}
    pairs = {"grad1": (prog["grad1"], refr["grad1"], kept_leaves(refr["grad1"])),
             "update": (prog["update"], refr["update"], kept_leaves(refr["grad1"]))}
    if 2 in refr["grads"] and 2 in prog.get("grads", {}):
        pairs["grad2"] = (prog["grads"][2], refr["grads"][2], kept_leaves(refr["grads"][2]))
    if refr.get("followed") is not None and prog.get("followed") is not None:
        g = refr["followed"]["grad"]
        pairs["followed_grad"] = (prog["followed"]["grad"], g, kept_leaves(g))
    for name, (p, r, keep) in pairs.items():
        gaps = leaf_gaps(p, r, keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        out[name] = {"worst_leaf": worst[0], "worst": gaps[worst[0]],
                     "median": statistics.median(gaps.values()),
                     "top": [[k, gaps[k]] for k in worst]}
    return out
