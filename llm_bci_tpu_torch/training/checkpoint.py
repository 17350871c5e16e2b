"""Full train-state checkpoint and resume (counterpart of
``llm_bci_tpu/training/checkpoint.py``, which saves a flax ``TrainState``
with Orbax).

A train state is a directory ``<root>/<step>/`` of ``torch.save`` files, one
for each part the trainer hands in (the model's ``state_dict``, the
optimizer's, the counters, generator states and partial gradients), and a
``meta.json`` written last. It is written into a temporary directory beside
it and moved into place with ``os.replace``: a save cut by preemption leaves
no ``<step>/`` directory, and a ``<step>/`` without ``meta.json`` is not taken
for a train state. The newest ``MAX_TO_KEEP`` steps are kept, as
``CheckpointManagerOptions(max_to_keep=3)`` does.

Restore is the JAX package's ``_overlay``: leaves are matched by name; a
leaf the checkpoint lacks (a frozen BCI base saved under
``training.component_blobs: false``), or one whose shape differs, keeps its
live value, and both are printed. Before matching, a saved LLM blob is put
into the live model's quantization layout
(``models/llama.py::adapt_state_dict_quantization``, the ``state_dict`` form
of ``ops/quant.py::adapt_quantization``).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

MAX_TO_KEEP = 3
META = "meta.json"


def _steps(directory: str) -> List[int]:
    """Steps with a complete train state under ``directory``, oldest first;
    a ``<step>/`` directory without ``meta.json`` is passed over with a
    printed warning."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.isdigit() or not os.path.isdir(os.path.join(directory, name)):
            continue
        if os.path.exists(os.path.join(directory, name, META)):
            steps.append(int(name))
        else:
            print(f"restore_train_state: {os.path.join(directory, name)} is incomplete "
                  f"(no {META}); ignored", flush=True)
    return sorted(steps)


def save_train_state(directory: str, step: int, parts: Dict[str, object]) -> str:
    """Write ``parts`` (name -> object that ``torch.save`` takes) as the
    train state of ``step``; returns its directory."""
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):          # what a cut save left behind
        if name.startswith(".tmp-"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    os.makedirs(tmp)
    for name, obj in parts.items():
        torch.save(obj, os.path.join(tmp, f"{name}.pt"))
    with open(os.path.join(tmp, META), "w") as f:
        json.dump({"step": int(step), "parts": sorted(parts)}, f)
    final = os.path.join(directory, str(int(step)))
    old = None
    if os.path.exists(final):                   # the same step saved again
        old = os.path.join(directory, f".tmp-old-{step}-{os.getpid()}")
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    for stale in _steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(stale)), ignore_errors=True)
    return final


def load_train_state(directory: str, step: Optional[int] = None
                     ) -> Tuple[int, Dict[str, object]]:
    """``(step, parts)`` of the newest train state (or of ``step``), every
    tensor on the CPU. Raises ``FileNotFoundError`` when there is none."""
    if step is None:
        steps = _steps(directory)
        step = steps[-1] if steps else None
    path = os.path.join(directory, str(step))
    if step is None or not os.path.exists(os.path.join(path, META)):
        raise FileNotFoundError(f"No checkpoints in {directory}")
    step = int(step)
    with open(os.path.join(path, META)) as f:
        names = json.load(f)["parts"]
    parts = {name: torch.load(os.path.join(path, f"{name}.pt"), map_location="cpu",
                              weights_only=True)
             for name in names}
    return step, parts


def _report(what: str, filled: List[str], mismatched: List[str], unexpected: List[str]) -> None:
    def head(keys):
        return f"{keys[:5]}{'...' if len(keys) > 5 else ''} ({len(keys)})"

    if filled:
        print(f"restore_train_state: the checkpoint has no {what} leaves for {head(filled)}; "
              "kept their live values", flush=True)
    if mismatched:
        print(f"restore_train_state: checkpoint {what} leaf shapes differ from the live ones; "
              f"kept live values for {head(mismatched)}", flush=True)
    if unexpected:
        print(f"restore_train_state: checkpoint {what} leaves with no live counterpart were "
              f"dropped: {head(unexpected)}", flush=True)


def overlay_model_state(model: torch.nn.Module, saved: Dict[str, torch.Tensor]) -> List[str]:
    """Load the saved leaves that fit ``model`` (same name and shape, cast to
    the live dtype); every other live leaf keeps its value. Returns the names
    of the leaves restored."""
    take = fit_model_state(saved, model.state_dict())
    model.load_state_dict(take, strict=False)
    return sorted(take)


def fit_model_state(saved: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The saved leaves that fit ``target`` (a ``state_dict``, or tensors of
    its names, shapes and dtypes on the meta device): same name and shape,
    cast to the target's dtype, after the LLM blob is put into the target's
    quantization layout; what does not fit is printed."""
    from llm_bci_tpu_torch.models.llama import adapt_state_dict_quantization

    saved = adapt_state_dict_quantization(saved, target)
    take, filled, mismatched = {}, [], []
    for key, live in target.items():
        value = saved.get(key)
        if value is None:
            filled.append(key)
        elif tuple(value.shape) != tuple(live.shape):
            mismatched.append(f"{key} {tuple(value.shape)}->{tuple(live.shape)}")
        else:
            take[key] = value.to(live.dtype)
    _report("model", filled, mismatched, sorted(set(saved) - set(target)))
    return take


def optimizer_state(optimizer: torch.optim.Optimizer, names: List[str]) -> Dict[str, object]:
    """The optimizer's ``state_dict`` with the names of its parameters (in
    the order of its index), so that restore matches leaves by name."""
    return {"names": list(names), "state_dict": optimizer.state_dict()}


def overlay_optimizer_state(optimizer: torch.optim.Optimizer, names: List[str],
                            params: List[torch.nn.Parameter], saved: Dict[str, object]) -> None:
    """Restore the per-parameter state (AdamW's ``step``, ``exp_avg``,
    ``exp_avg_sq``) by parameter name where its shape fits, and the
    hyper-parameters of the groups; other leaves keep their live state."""
    live = optimizer.state_dict()
    saved_sd = saved["state_dict"]
    by_name = dict(zip(saved["names"], range(len(saved["names"]))))
    state, filled, mismatched = {}, [], []
    for idx, (name, p) in enumerate(zip(names, params)):
        entry = saved_sd["state"].get(by_name.get(name, -1))
        if entry is None:
            filled.append(name)
            if idx in live["state"]:
                state[idx] = live["state"][idx]
            continue
        shapes = [tuple(v.shape) for k, v in entry.items() if k != "step" and torch.is_tensor(v)]
        if any(shape != tuple(p.shape) for shape in shapes):
            mismatched.append(name)
            if idx in live["state"]:
                state[idx] = live["state"][idx]
            continue
        state[idx] = entry
    groups = live["param_groups"]
    if len(saved_sd["param_groups"]) == len(groups):
        groups = [{**s, "params": g["params"]} for s, g in zip(saved_sd["param_groups"], groups)]
    _report("optimizer", filled, mismatched, sorted(set(saved["names"]) - set(names)))
    optimizer.load_state_dict({"state": state, "param_groups": groups})


def restore_generator(generator: torch.Generator, state: Optional[torch.Tensor],
                      what: str) -> None:
    """Set ``generator`` to a saved state; a state of another size (a CPU
    generator's saved for a CUDA one) keeps the live state, printed."""
    if state is None:
        return
    live = generator.get_state()
    if state.numel() != live.numel():
        print(f"restore_train_state: the saved {what} state has {state.numel()} bytes, the "
              f"live {generator.device} generator {live.numel()}; kept the live state",
              flush=True)
        return
    generator.set_state(state)
