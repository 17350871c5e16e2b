"""Trainer — config-driven train / eval loop on one device (counterpart of
the core of ``llm_bci_tpu/training/trainer.py``).

Kept from the JAX trainer: the config schema, dataset and collate
construction, the static pad lengths, the stateless ``(seed, epoch)``
batch order, ``max_steps`` / ``eval_every`` / ``save_every``, the
metric-fn protocol ``fn(model, model_inputs, unused_inputs, outputs,
**metric_kwargs)`` with ``fn.prepare(outputs)`` handed back as
``prepared=`` (a host numpy array here), and the gradient of ``out.loss``
itself — the sum over the batch, not a mean.

Changed for PyTorch: the jitted step is an eager step under
``torch.autocast`` with ``precision.compute_dtype`` (float32 master
weights); dropout, noise and maskers draw from one ``torch.Generator`` on
the device, seeded from ``config.seed`` and advanced by every step; a checkpoint is the model's and the optimizer's
``state_dict`` plus ``trainer_config.yaml`` under ``STEP{n}/``. Metric fns
are read back every step (no lag). The frozen / trainable split is
``requires_grad`` (the JAX trainer's ``trainable_mask``): the optimizer
takes only the parameters that train. A model with ``save_checkpoint`` /
``save_config`` (BCI) writes its own component blobs instead of
``model.pt``; ``training.component_blobs: false`` leaves its frozen leaves
out. ``precision.compute_dtype`` and the device reach ``from_config`` (BCI
stores its frozen Llama base on the device in that dtype), and a model
with ``warm_start`` loads its ``from_pt`` / ``llm_path`` weights.

Not ported yet (see ROADMAP.md): resume (``training.resume``), multi-device
parallelism, ``optimizer.grad_clip_norm``, datasets named by the config,
TensorBoard / W&B logging and profiling. The TPU-only
performance knobs ``chain_steps``, ``metric_lag`` and
``cache_device_batches`` change no result and are ignored.
"""
from __future__ import annotations

import inspect
import os
import time
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import yaml

from llm_bci_tpu_torch.config import DictConfig, resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch.data.datasets import pad_collate_fn
from llm_bci_tpu_torch import not_ported
import llm_bci_tpu_torch.data  # noqa: F401  (fills NAME2DATASET)
from llm_bci_tpu_torch.registry import NAME2DATASET, NAME2MODEL
import llm_bci_tpu_torch.models  # noqa: F401  (fills NAME2MODEL)
from llm_bci_tpu_torch.training.dataloader import HostDataLoader, freeze_pad_lengths
from llm_bci_tpu_torch.training.optim import build_optimizer

DEFAULT_TRAINER_CONFIG = "configs/trainer.yaml"
DTYPES = {None: torch.float32, "float32": torch.float32, "fp32": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float16": torch.float16, "fp16": torch.float16}


def default_trainer_config() -> DictConfig:
    return update_config(resolve_path(DEFAULT_TRAINER_CONFIG), None)


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; a CUDA device without a card raises (there is
    no silent CPU run)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Trainer: CUDA is not available; pass device='cpu' explicitly to run on the CPU"
        )
    return device


class Trainer:
    def __init__(
        self,
        config,
        model: Optional[torch.nn.Module] = None,
        dataset: Optional[Dict[str, List[Dict[str, Any]]]] = None,
        metric_fns: Optional[Dict[str, Callable]] = None,
        eval_metric_fns: Optional[Dict[str, Callable]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = update_config(default_trainer_config(), config)
        cfg = self.config
        if cfg.training.get("resume"):
            raise not_ported("training.resume (checkpoint resume)", "Queue 1, slice 1, item 5")
        par = cfg.get("parallelism") or {}
        if any(int(par.get(k, 1)) > 1 for k in ("data", "fsdp", "tp", "sp")):
            raise not_ported("Multi-device parallelism", "Queue 1, slice 8, item 12")
        if cfg.optimizer.get("grad_clip_norm"):
            raise not_ported("optimizer.grad_clip_norm", "Queue 1, slice 1, item 5")
        prec = cfg.get("precision") or {}
        if DTYPES[prec.get("param_dtype")] != torch.float32:
            raise ValueError("precision.param_dtype must be float32 (master weights)")
        self.compute_dtype = DTYPES[prec.get("compute_dtype")]
        self.verbosity = cfg.verbosity
        self.seed = int(cfg.seed)
        torch.manual_seed(self.seed)
        self.generator = torch.Generator(self.device).manual_seed(self.seed)

        self.print_v(yaml.safe_dump(to_plain_dict(cfg), default_flow_style=False), verbosity=0)
        self.checkpoint_dir = os.path.join(cfg.dirs.checkpoint_dir, cfg.savestring)
        os.makedirs(self.checkpoint_dir, exist_ok=True)

        if dataset is None:
            raise not_ported("Datasets named by the config (data.hf_dataset_name, "
                             "data.json_dataset_name)", "Queue 1, slice 1, item 5")
        self.dataset = dataset
        self.set_model(model)
        self.get_model_inputs()
        self.build_dataloaders()
        self.print_v("Building optimizers", verbosity=0)
        grad_accum = int(cfg.optimizer.get("gradient_accumulation_steps", 1) or 1)
        self.grad_accum = grad_accum
        trainable = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer, self.schedule = build_optimizer(
            trainable, cfg.optimizer,
            steps_per_epoch=len(self.train_dataloader),
            num_epochs=int(cfg.training.num_epochs),
        )
        self.n_updates = 0      # optimizer updates (the schedule's count)
        self.n_micro = 0        # train steps (micro-batches)
        self.metric_kwargs = dict(cfg.method.metric_kwargs)
        self.metric_fns = metric_fns or {}
        self.eval_metric_fns = eval_metric_fns or {}
        self.eval_history: List[Dict[str, Any]] = []
        n_params = sum(p.numel() for p in trainable)
        self.print_v(f"Model number of trainable parameters: {n_params:,}", verbosity=0)

    # ------------------------------------------------------------- plumbing

    def print_v(self, *args, verbosity: int = 3) -> None:
        if verbosity >= self.verbosity:
            print(*args, flush=True)

    def set_model(self, model) -> None:
        if model is None:
            model_class = NAME2MODEL[self.config.model.model_class]
            kwargs = dict(self.config.method.model_kwargs)
            kwargs.setdefault(
                "compute_dtype", (self.config.get("precision") or {}).get("compute_dtype"))
            model = model_class.from_config(self.config.model, device=self.device, **kwargs)
            if hasattr(model, "warm_start"):
                model.warm_start()
        self.model = model.to(self.device)

    def get_model_inputs(self) -> None:
        """Batch columns that go to the model: the parameters of its
        ``forward``."""
        sig = inspect.signature(type(self.model).forward)
        skip = {"self", "generator", "masker_overrides"}
        self.model_inputs = [p for p in sig.parameters if p not in skip]

    def build_dataloaders(self) -> None:
        self.print_v("Building dataloaders", verbosity=0)
        cfg = self.config
        dataset_class = NAME2DATASET[cfg.data.dataset_class]
        kwargs = dict(cfg.method.dataset_kwargs)
        self.train_dataset = dataset_class(
            self.dataset[cfg.data.train_name], length=cfg.data.train_len, **kwargs
        )
        self.test_dataset = dataset_class(
            self.dataset[cfg.data.test_name], length=cfg.data.test_len, **kwargs
        )
        pad_dict = to_plain_dict(cfg.method.dataloader_kwargs.pad_dict)
        pad_dict = freeze_pad_lengths([self.train_dataset, self.test_dataset], pad_dict)
        collate = partial(pad_collate_fn, model_inputs=self.model_inputs, pad_dict=pad_dict)
        self.train_dataloader = HostDataLoader(
            self.train_dataset, batch_size=cfg.training.train_batch_size, collate_fn=collate,
            shuffle=True, drop_last=bool(cfg.training.get("drop_last_train_dataloader", False)),
            seed=self.seed,
        )
        self.test_dataloader = HostDataLoader(
            self.test_dataset, batch_size=cfg.training.test_batch_size, collate_fn=collate,
            shuffle=bool(cfg.training.get("shuffle_test_dataloader", False)),
            drop_last=bool(cfg.training.get("drop_last_test_dataloader", False)),
            seed=self.seed + 1,
        )

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Numpy columns -> tensors on the device (other columns stay out)."""
        return {
            k: torch.from_numpy(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
            if isinstance(v, np.ndarray)
        }

    def autocast(self):
        """``torch.autocast`` to ``precision.compute_dtype`` (off for float32)."""
        return torch.autocast(
            self.device.type, dtype=self.compute_dtype,
            enabled=self.compute_dtype != torch.float32,
        )

    def _metrics(self, metric_fns, model_inputs, unused_inputs, outputs) -> Dict[str, float]:
        vals = {}
        for name, fn in metric_fns.items():
            kwargs = dict(self.metric_kwargs)
            if hasattr(fn, "prepare"):
                kwargs["prepared"] = fn.prepare(outputs).detach().cpu().numpy()
            vals[name] = float(fn(self.model, model_inputs, unused_inputs, outputs, **kwargs))
        return vals

    # ----------------------------------------------------------------- step

    def train_step(self, dev_batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One forward/backward on a device batch; an optimizer update every
        ``gradient_accumulation_steps`` calls. Returns the outputs dict."""
        self.model.train()
        with self.autocast():
            out = self.model(**dev_batch, generator=self.generator)
        # The gradient of the summed loss, as the JAX trainer takes it; the
        # micro-batch gradients of one update are averaged (optax.MultiSteps).
        (out.loss / self.grad_accum).backward()
        self.n_micro += 1
        if self.n_micro % self.grad_accum == 0:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.n_updates)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.n_updates += 1
        return {k: (v.detach() if torch.is_tensor(v) else v) for k, v in out.to_dict().items()}

    # ------------------------------------------------------------- evaluate

    @torch.no_grad()
    def evaluate(self, additional_metric_fns: Optional[Dict[str, Callable]] = None,
                 eval_train_set: bool = False):
        metric_fns = dict(self.metric_fns)
        metric_fns.update(additional_metric_fns or {})
        self.model.eval()
        losses, examples = [], []
        metrics: Dict[str, List[float]] = {name: [] for name in metric_fns}
        loader = self.train_dataloader if eval_train_set else self.test_dataloader
        for model_inputs, unused_inputs in loader:
            with self.autocast():
                out = self.model(**self.to_device(model_inputs), generator=self.generator)
            outputs = out.to_dict()
            losses.append(outputs["loss"])
            examples.append(outputs["n_examples"])
            for name, v in self._metrics(metric_fns, model_inputs, unused_inputs, outputs).items():
                metrics[name].append(v)
        total_examples = float(sum(float(x) for x in examples))
        total_loss = float(sum(float(x) for x in losses))
        avg_loss = total_loss / total_examples if total_examples > 0 else 0.0
        return avg_loss, {k: (sum(v) / len(v) if v else 0.0) for k, v in metrics.items()}

    # ----------------------------------------------------------------- train

    def train(self) -> None:
        cfg = self.config
        self.print_v(f"Starting run {cfg.savestring}", verbosity=0)
        max_steps = cfg.training.get("max_steps")
        eval_every = cfg.training.get("eval_every")
        save_every = cfg.training.get("save_every")
        steps_per_epoch = max(len(self.train_dataloader), 1)
        n_epochs = int(cfg.training.num_epochs)
        budget = int(max_steps) if max_steps else steps_per_epoch * n_epochs

        step = 1
        train_loss, train_examples = [], []
        train_metrics: Dict[str, List[float]] = {name: [] for name in self.metric_fns}
        window_t0, window_samples = time.perf_counter(), 0
        for epoch in range(1, n_epochs + 1):
            self.print_v(f"Epoch {epoch}", verbosity=1)
            self.train_dataloader.set_epoch(epoch)
            for model_inputs, unused_inputs in self.train_dataloader:
                outputs = self.train_step(self.to_device(model_inputs))
                window_samples += int(outputs["n_examples"])
                train_loss.append(outputs["loss"])
                train_examples.append(outputs["n_examples"])
                for name, v in self._metrics(
                    self.metric_fns, model_inputs, unused_inputs, outputs
                ).items():
                    train_metrics[name].append(v)

                if eval_every and step % eval_every == 0:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    dt = time.perf_counter() - window_t0
                    test_loss, test_metrics = self.evaluate(self.eval_metric_fns)
                    n = float(sum(float(x) for x in train_examples))
                    train_avg = float(sum(float(x) for x in train_loss)) / n if n else 0.0
                    train_avg_metrics = {
                        k: (sum(v) / len(v) if v else 0.0) for k, v in train_metrics.items()
                    }
                    throughput = window_samples / dt if dt > 0 else 0.0
                    self.eval_history.append({
                        "step": step, "train_avg_loss": train_avg,
                        "train_avg_metrics": train_avg_metrics, "test_avg_loss": test_loss,
                        "test_avg_metrics": test_metrics, "samples_per_sec": throughput,
                    })
                    self.print_v(
                        f"savestring={cfg.savestring} global_step={step}:\n"
                        f"train_avg_loss={train_avg} train_avg_metrics={train_avg_metrics}\n"
                        f"test_avg_loss={test_loss} test_avg_metrics={test_metrics}\n"
                        f"throughput={throughput:.1f} samples/s (train steps and metric fns, "
                        f"device {self.device})",
                        verbosity=1,
                    )
                    train_loss, train_examples = [], []
                    train_metrics = {name: [] for name in self.metric_fns}
                    window_t0, window_samples = time.perf_counter(), 0
                if save_every and step % save_every == 0:
                    self.save_checkpoint(f"STEP{step}")
                if step >= budget:
                    self.print_v("Reached max_steps" if max_steps else "Step budget done",
                                 verbosity=1)
                    return
                step += 1
        self.print_v("Training done", verbosity=1)

    # ----------------------------------------------------------- checkpoint

    def save_checkpoint(self, tag: str) -> None:
        """``STEP{n}/``: the model's ``state_dict`` (or its own component
        blobs and configs), the optimizer's ``state_dict`` and the config."""
        path = os.path.join(self.checkpoint_dir, tag)
        os.makedirs(path, exist_ok=True)
        self.print_v(f"Saving checkpoint to {path}", verbosity=1)
        if hasattr(self.model, "save_checkpoint"):
            self.model.save_checkpoint(
                path, include_frozen=bool(self.config.training.get("component_blobs", True)))
            self.model.save_config(path)
        else:
            torch.save(self.model.state_dict(), os.path.join(path, "model.pt"))
        torch.save(self.optimizer.state_dict(), os.path.join(path, "optimizer.pt"))
        with open(os.path.join(path, "trainer_config.yaml"), "w") as f:
            yaml.safe_dump(to_plain_dict(self.config), f)
