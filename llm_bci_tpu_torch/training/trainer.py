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
``state_dict`` plus ``trainer_config.yaml`` under ``STEP{n}/``. The frozen / trainable split is
``requires_grad`` (the JAX trainer's ``trainable_mask``): the optimizer
takes only the parameters that train. A model with ``save_checkpoint`` /
``save_config`` (BCI) writes its own component blobs instead of
``model.pt``; ``training.component_blobs: false`` leaves its frozen leaves
out. ``precision.compute_dtype`` and the device reach ``from_config`` (BCI
stores its frozen Llama base on the device in that dtype), and a model
with ``warm_start`` loads its ``from_pt`` / ``llm_path`` weights.

As in the JAX trainer: the step's ``loss``, ``n_examples`` and every metric
fn's ``fn.prepare(outputs)`` stay on the device and are read back in one
batch every ``training.metric_lag`` steps (default 4) and at every eval, save
and preemption boundary and the end of training; the metric fns run then, on
the host arrays (:class:`LaggedReadback`). Values and their step labels are
those of ``metric_lag: 1``; only when they are read moves, so the host can
enqueue the next steps while the device runs. ``training.halt_on_nonfinite``
raises ``FloatingPointError`` at an eval whose losses are not finite;
``training.save_on_preemption`` (default true) installs a SIGTERM handler
that, like :meth:`Trainer.request_preemption`, makes the next step boundary
save ``STEP{n}`` and return; ``dirs.log_dir`` writes TensorBoard scalars and
``log_to_wandb`` logs each eval to Weights & Biases, each skipped when its
package is not installed.

Not ported yet (see ROADMAP.md): resume (``training.resume``), multi-device
parallelism, ``optimizer.grad_clip_norm``, datasets named by the config and
profiling. The TPU-only performance knobs ``chain_steps`` and
``cache_device_batches`` change no result and are ignored.
"""
from __future__ import annotations

import inspect
import os
import signal
import time
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import yaml

from llm_bci_tpu_torch.config import (
    DictConfig,
    config_from_kwargs,
    resolve_path,
    to_plain_dict,
    update_config,
)
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


def to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Tensors as numpy arrays, with one device-to-host copy for each device
    and dtype among them (the tensors of one travel flattened together)."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx]).cpu().numpy()
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].reshape(tuple(tensors[i].shape))
            off += n
    return out


class LaggedReadback:
    """Steps' outputs kept on the device and read back in batches (the JAX
    trainer's ``_LaggedMetricReadback``). ``add(ctx, outputs)`` calls every
    metric fn's ``prepare`` right behind the step and queues the entry; once
    ``lag`` entries wait they are read back together, and ``consume(ctx,
    outputs, loss, n_examples, prepared)`` runs for each, oldest first, with
    host values. ``flush()`` drains what waits; ``drains`` counts the
    batches."""

    def __init__(self, metric_fns: Dict[str, Callable], lag: int, consume: Callable):
        self.metric_fns = metric_fns
        self.lag = max(1, int(lag or 1))
        self.consume = consume
        self.pending: List[Any] = []
        self.drains = 0

    def add(self, ctx, outputs: Dict[str, Any]) -> None:
        prepared = {name: fn.prepare(outputs) for name, fn in self.metric_fns.items()
                    if hasattr(fn, "prepare")}
        self.pending.append((ctx, outputs, prepared))
        if len(self.pending) >= self.lag:
            self.flush()

    def flush(self) -> None:
        if not self.pending:
            return
        entries, self.pending = self.pending, []
        tensors = []
        for _, outputs, prepared in entries:
            tensors += [torch.as_tensor(outputs["loss"]), torch.as_tensor(outputs["n_examples"])]
            tensors += list(prepared.values())
        host = iter(to_host(tensors))
        self.drains += 1
        for ctx, outputs, prepared in entries:
            loss, n = float(next(host)), float(next(host))
            self.consume(ctx, outputs, loss, n, {name: next(host) for name in prepared})


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
        self.init_logging()
        self._preempt_flag = False

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
        self.metric_lag = int(cfg.training.get("metric_lag", 4) or 1)
        self.metric_fns = metric_fns or {}
        self.eval_metric_fns = eval_metric_fns or {}
        self.eval_history: List[Dict[str, Any]] = []
        n_params = sum(p.numel() for p in trainable)
        self.print_v(f"Model number of trainable parameters: {n_params:,}", verbosity=0)

    # ------------------------------------------------------------- plumbing

    def print_v(self, *args, verbosity: int = 3) -> None:
        if verbosity >= self.verbosity:
            print(*args, flush=True)

    def init_logging(self) -> None:
        """Weights & Biases (``log_to_wandb``; a sweep's values update the
        config) and a TensorBoard writer under ``dirs.log_dir``, each
        imported here and skipped when its package is missing."""
        cfg = self.config
        self.wandb = None
        if cfg.get("log_to_wandb"):
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=cfg.get("wandb_project"))
                self.config = update_config(
                    self.config, config_from_kwargs(dict(wandb.config), convert=False))
            except ImportError:
                self.print_v("wandb not available; disabling", verbosity=0)
        self.writer = None
        if cfg.dirs.get("log_dir"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir=os.path.join(cfg.dirs.log_dir, cfg.savestring))
            except ImportError:
                pass

    def request_preemption(self) -> None:
        """Ask a running ``train()`` to save ``STEP{n}`` at the next step
        boundary and return. The SIGTERM handler while training
        (``training.save_on_preemption``, default true)."""
        self._preempt_flag = True

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

    def _metrics(self, metric_fns, model_inputs, unused_inputs, outputs,
                 prepared: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Every metric fn on one step's outputs; ``prepared`` holds the host
        values of the fns' ``prepare`` hooks."""
        vals = {}
        for name, fn in metric_fns.items():
            kwargs = dict(self.metric_kwargs)
            if name in prepared:
                kwargs["prepared"] = prepared[name]
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

        def consume(ctx, outputs, loss, n, prepared):
            losses.append(loss)
            examples.append(n)
            for name, v in self._metrics(metric_fns, *ctx, outputs, prepared).items():
                metrics[name].append(v)

        readback = LaggedReadback(metric_fns, self.metric_lag, consume)
        loader = self.train_dataloader if eval_train_set else self.test_dataloader
        for model_inputs, unused_inputs in loader:
            with self.autocast():
                out = self.model(**self.to_device(model_inputs), generator=self.generator)
            readback.add((model_inputs, unused_inputs), out.to_dict())
        readback.flush()
        total_examples = float(sum(examples))
        total_loss = float(sum(losses))
        avg_loss = total_loss / total_examples if total_examples > 0 else 0.0
        return avg_loss, {k: (sum(v) / len(v) if v else 0.0) for k, v in metrics.items()}

    # ----------------------------------------------------------------- train

    def train(self) -> None:
        cfg = self.config
        self.print_v(f"Starting run {cfg.savestring}", verbosity=0)
        max_steps = cfg.training.get("max_steps")
        eval_every = cfg.training.get("eval_every")
        save_every = cfg.training.get("save_every")
        halt_on_nonfinite = bool(cfg.training.get("halt_on_nonfinite", False))
        steps_per_epoch = max(len(self.train_dataloader), 1)
        n_epochs = int(cfg.training.num_epochs)
        budget = int(max_steps) if max_steps else steps_per_epoch * n_epochs

        train_loss, train_examples = [], []
        train_metrics: Dict[str, List[float]] = {name: [] for name in self.metric_fns}
        window = {"t0": time.perf_counter(), "samples": 0}

        def consume(ctx, outputs, loss, n, prepared):
            step, model_inputs, unused_inputs = ctx
            window["samples"] += int(n)
            train_loss.append(loss)
            train_examples.append(n)
            if self.writer is not None:
                self.writer.add_scalar("Loss/train_iter", loss / n if n > 0 else 0.0, step)
            # train_metrics is rebound at each eval: the closure reads the live name
            for name, v in self._metrics(self.metric_fns, model_inputs, unused_inputs, outputs,
                                         prepared).items():
                train_metrics[name].append(v)
                if self.writer is not None:
                    self.writer.add_scalar(f"{name}/train_iter", v, step)

        self.readback = readback = LaggedReadback(self.metric_fns, self.metric_lag, consume)
        previous_handler = None
        if bool(cfg.training.get("save_on_preemption", True)):
            try:
                previous_handler = signal.signal(signal.SIGTERM,
                                                 lambda signum, frame: self.request_preemption())
            except ValueError:     # not the main thread: request_preemption() remains
                previous_handler = None
        try:
            step = 1
            for epoch in range(1, n_epochs + 1):
                self.print_v(f"Epoch {epoch}", verbosity=1)
                self.train_dataloader.set_epoch(epoch)
                for model_inputs, unused_inputs in self.train_dataloader:
                    outputs = self.train_step(self.to_device(model_inputs))
                    readback.add((step, model_inputs, unused_inputs), outputs)

                    if self._preempt_flag:
                        self.print_v(f"Preemption: saving at step {step} and stopping",
                                     verbosity=0)
                        readback.flush()
                        self.save_checkpoint(f"STEP{step}")
                        self._preempt_flag = False
                        return
                    if eval_every and step % eval_every == 0:
                        readback.flush()
                        dt = time.perf_counter() - window["t0"]
                        test_loss, test_metrics = self.evaluate(self.eval_metric_fns)
                        n = float(sum(train_examples))
                        train_avg = float(sum(train_loss)) / n if n else 0.0
                        train_avg_metrics = {
                            k: (sum(v) / len(v) if v else 0.0) for k, v in train_metrics.items()
                        }
                        throughput = window["samples"] / dt if dt > 0 else 0.0
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
                        self.log_eval(step, train_avg, train_avg_metrics, test_loss, test_metrics,
                                      throughput)
                        train_loss.clear()
                        train_examples.clear()
                        train_metrics = {name: [] for name in self.metric_fns}
                        window = {"t0": time.perf_counter(), "samples": 0}
                        if halt_on_nonfinite and not (np.isfinite(train_avg)
                                                      and np.isfinite(test_loss)):
                            if self.writer is not None:
                                self.writer.flush()
                            raise FloatingPointError(
                                f"Non-finite loss at step {step} (train={train_avg}, "
                                f"test={test_loss}); halting. Resume from the last finite "
                                "checkpoint with training.resume=true.")
                    if save_every and step % save_every == 0:
                        readback.flush()
                        self.save_checkpoint(f"STEP{step}")
                    if step >= budget:
                        readback.flush()
                        self.print_v("Reached max_steps" if max_steps else "Step budget done",
                                     verbosity=1)
                        return
                    step += 1
            readback.flush()
            self.print_v("Training done", verbosity=1)
        finally:
            if self.writer is not None:
                self.writer.flush()
            if previous_handler is not None:
                signal.signal(signal.SIGTERM, previous_handler)

    def log_eval(self, step, train_avg, train_avg_metrics, test_loss, test_metrics,
                 throughput) -> None:
        """One eval's averages to TensorBoard and W&B, where they are on."""
        if self.writer is not None:
            self.writer.add_scalar("throughput/samples_per_sec", throughput, step)
            self.writer.add_scalar("Loss/train", train_avg, step)
            for name, v in train_avg_metrics.items():
                self.writer.add_scalar(f"{name}/train", v, step)
            self.writer.add_scalar("Loss/test", test_loss, step)
            for name, v in test_metrics.items():
                self.writer.add_scalar(f"{name}/test", v, step)
        if self.wandb is not None:
            self.wandb.log({"step": step, "train_avg_loss": train_avg, **train_avg_metrics,
                            "test_avg_loss": test_loss, **test_metrics})

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
