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
weights); dropout, noise and maskers of a training step draw from one
``torch.Generator`` on the device, seeded from ``config.seed`` and advanced
by every step, and those of an eval from a second one, seeded apart, so that
evaluating never moves the training stream (the JAX trainer keeps its
training key in the ``TrainState`` and splits eval keys from another). A
checkpoint is the model's and the optimizer's ``state_dict`` plus
``trainer_config.yaml`` under ``STEP{n}/``, and the full train state under
``train_state/<step>/`` (``training/checkpoint.py``: model, optimizer, the
update and step counts, both generators' states and, inside an accumulation
window, the partial gradients), from which :meth:`Trainer.resume_from`
continues bit for bit on the CPU. The frozen / trainable split is
``requires_grad`` (the JAX trainer's ``trainable_mask``): the optimizer
takes only the parameters that train. A model with ``save_checkpoint`` /
``save_config`` (NDT1, iTransformer, PatchTST, BCI) writes its own component
blobs and configs instead of ``model.pt``; ``training.component_blobs:
false`` leaves its frozen leaves out. ``precision.compute_dtype`` and the
device reach ``from_config`` (BCI stores its frozen Llama base on the device
in that dtype), and a model with ``warm_start`` loads its ``from_pt`` /
``llm_path`` weights when it is built; a later :meth:`Trainer.resume_from`
overlays its restored state on them, as the JAX trainer restores over its
warm start.

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

``optimizer.grad_clip_norm`` clips the averaged gradient of an update by
its global norm over the trainable parameters (``training/optim.py``).
``profile: {start_step, num_steps, dir}`` records ``num_steps`` steps from
``start_step`` with ``torch.profiler`` (CPU and, on the card, CUDA
activities) and writes a Chrome trace to ``dir``. A dataset not handed in
comes from ``data.hf_dataset_name`` (``datasets.load_dataset``) or
``data.json_dataset_name`` (a JSON file), and a ``str`` dataset is a JSON
path. ``precision.remat`` (``configs/trainer.yaml``) is read by nothing, as
in the JAX package: remat is the model's ``encoder.remat`` (NDT1) or
``llm_remat`` (BCI).

Multi-device training (``parallelism``, ``parallel/``): once a process
group is up, the trainer builds the ``(data, fsdp, sp, tp)`` mesh over the
world and applies the plan at every mesh size, trivial axes included: the
Llama projections of a BCI are cut to the rank's tensor-parallel share
(``parallel/tensor_parallel.py``), then FSDP2 ``fully_shard`` shards the
model over the ``(data, fsdp)`` sub-mesh (replicated over ``data``, sharded
over ``fsdp``), the float32 master weights kept under autocast as on one
device. Every rank walks the same global batches; a rank keeps the rows of
its ``data`` index (a batch the axis does not divide stays whole), and its
loss is scaled so that the reduced gradient is that of the global batch's
summed loss. A step's ``loss`` and ``n_examples`` are summed over ``data``;
when metric fns run, the batch-dim outputs are gathered, so that the fns see
the global batch as on one device. Only rank 0 prints, logs and writes; a
checkpoint gathers the full state (``save_checkpoint``) and is written in
the single-device format, which any world size resumes
(:meth:`resume_from`). Statistics over the batch (PatchTST's BatchNorm) are
those of the global batch: a model whose ``forward`` takes ``batch_group``
gets the group of the ranks whose rows (and time parts) make it up. With
``sp > 1`` (sequence parallelism, every family) the ranks of an ``sp`` group
hold the same rows and each a part of their time axis: ``to_device`` cuts each time-dim key to the range the
model's ``sequence_layout`` gives the rank (its tokens' bins and their
halo; a time dim that ``sp`` does not divide stays whole, and a batch with
no ``spikes`` key, PhonemeLLM's, too: the ranks then compute the same and
scale nothing, as the JAX trainer keeps such a key replicated), the model
makes the wholes it needs over the group (``parallel/sequence.py``: K / V
and log-prob gathers, row-parallel sums, synced statistics, shard 0's
prefix outputs), and FSDP2 reduces over ``data x sp``
(``parallel/mesh.py::fsdp_mesh``). The gradient rule: every such collective
sums its backward over ``sp``, and the loss is scaled by ``sp`` (as by
``data``) only where the model's ``sequence_outputs()`` says a rank's loss
is its part of the whole (mlm, autoregressive); where every rank holds the
whole loss (``ctc``, BCI, the behaviour heads) it is left as it is. A step's
``loss`` and ``n_examples`` are summed over ``sp`` where they are the rank's
part and taken once where every rank holds the whole, and the metric fns
see the time-dim outputs gathered along each key's time dim. Random draws
on that path are made at the whole sequence's shape and sliced, so ``sp``
changes no result. The keys of the JAX trainer's ``parallelism`` block:
``data`` / ``fsdp`` / ``sp`` / ``tp`` read; ``sp_keys`` accepted, any
list, and changing no result: in the JAX trainer the list only places the
data, and GSPMD gives every placement the same values, while the port's
model needs its own time keys cut by its ``sequence_layout``. So the port
cuts the keys the layout gives a range (``spikes``, ``spikes_mask``,
``spikes_timestamp``) whether they are listed or not, and keeps every other
key whole on every rank, listed or not (``phoneme_probs``, ``targets``, a
key without a time dim): a run's results equal the default list's;
``sp`` with ``tp`` (the BCI and PhonemeLLM): FSDP2's replicate dim is
``data x sp`` at each ``tp`` index, the ``tp`` ranks holding their shares of
the Llama (``parallel/mesh.py::fsdp_mesh``);
``multihost: true`` starts the process group from the launcher's
environment (``torchrun`` sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``;
the group is also started whenever those are set), the counterpart of
``jax.distributed.initialize``; ``fsdp_min_size`` says which modules get an
FSDP2 group of their own (``parallel/mesh.py::fsdp_groups``);
``training.preemption_sync_every`` (default 10): with several ranks a
preemption request is agreed on every that many steps, so that every rank
stops and saves at the same step. ``dirs.compilation_cache_dir`` is ignored:
it is XLA's compile cache, and the port compiles no XLA program (the CUDA
kernels are cached by source hash under ``llm_bci_tpu_torch/_build``).
A rank's training and eval generators are seeded from ``config.seed`` and
its ``data`` index (index 0: the single process's seeds; ``train_seed``), so
the ``fsdp`` and ``sp`` ranks of one data index draw in lockstep.
The models' random parts draw from them, the flash dropout seed too
(``ops/flash_attention.py::draw_seed``), so with dropout on rank 0 draws
what one process draws for its rows and the other data ranks draw streams of
their own, where one process would draw the rest of one stream (the JAX
package folds the data index into the flash key instead,
``llm_bci_tpu/ops/flash_attention.py:558``).

``training.chain_steps: K > 1`` runs K train steps of one batch signature in
a row, as the JAX trainer runs them in one ``lax.scan`` program: a chain is
taken when K batches of one signature (keys, shapes, dtypes) wait and no
eval, save, profile or budget boundary falls inside it (one may be its last
step); shorter runs (near a boundary, a shape change, an epoch's tail, the
profiled steps) take the single step. Each step of a chain keeps its own
bookkeeping: its outputs reach the readback with their own step label, the
eval / save / budget logic runs for each, and a preemption is honoured at
the chain's end, saved under the true step. Each step of a chain goes
through the step graph of its signature and of its place in
``gradient_accumulation_steps`` (closing an update or not,
``training/step_graph.py``): the batch is copied into the graph's slots,
the graph's outputs are copied out before the readback holds them, and the
AdamW update then runs eagerly, as a single step's does (its learning rate
and bias corrections are host floats; an AdamW captured with them on the
device moved the flagship's bf16 losses by up to 1.3e-4 in 8 steps on an
NVIDIA H100 80GB HBM3 at 700 W). On the card, in one process or under an
NCCL group, the forward and backward (and at an update the clip) of the
graph's second step are captured and replayed by every later step, FSDP2's
all-gathers and reduce-scatters, the ``tp`` / ``sp`` collectives and the
clip's all-reduces inside; such a run keeps its gradients at fixed addresses
(zeroed after an update instead of freed), which changes no value. On the
CPU, and on gloo ranks (whose collectives run on the host and cannot be
captured; decided from the backend, and said once), the slots run eagerly.
Either way a chained run equals the unchained one. The graphs, and the
activations their pools hold, are freed at the end of :meth:`train`.
``training.cache_device_batches: true`` keeps a loader's collated columns on
the device after its first complete pass and re-batches later epochs by a
device gather in the streaming order (``training/batch_cache.py``); with
chains the gather writes into the step graph's slots, so such an epoch
copies no batch from the host. Under a process group every rank pools every
row of the global batches in its own time range (every rank reads the same
host batches), and gathers its ``data`` rows of each replayed batch
(:meth:`pooled_batch`), equal bit for bit to what :meth:`to_device` cuts from
the same host batch; the whole dataset is on every card (the JAX pool is
sharded over ``data``).
"""
from __future__ import annotations

import contextlib
import inspect
import json
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
import llm_bci_tpu_torch.data  # noqa: F401  (fills NAME2DATASET)
from llm_bci_tpu_torch.registry import NAME2DATASET, NAME2MODEL
import llm_bci_tpu_torch.models  # noqa: F401  (fills NAME2MODEL)
from llm_bci_tpu_torch.parallel import mesh as pmesh
from llm_bci_tpu_torch.parallel import process
from llm_bci_tpu_torch.parallel.sequence import SP_KEYS, SequenceShard, whole_sequence_outputs
from llm_bci_tpu_torch.training import checkpoint
from llm_bci_tpu_torch.training import distributed as tdist
from llm_bci_tpu_torch.training import step_graph
from llm_bci_tpu_torch.training.batch_cache import DeviceBatchCache, PoolRows
from llm_bci_tpu_torch.training.dataloader import HostDataLoader, freeze_pad_lengths
from llm_bci_tpu_torch.training.optim import build_optimizer, clip_by_global_norm
from llm_bci_tpu_torch.training.step_graph import TrainStepGraph, batch_signature

DEFAULT_TRAINER_CONFIG = "configs/trainer.yaml"
DTYPES = {None: torch.float32, "float32": torch.float32, "fp32": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float16": torch.float16, "fp16": torch.float16}


def default_trainer_config() -> DictConfig:
    return update_config(resolve_path(DEFAULT_TRAINER_CONFIG), None)


def eval_seed(seed: int, data_index: int = 0) -> int:
    """Seed of the eval generator: a function of ``config.seed`` that is not
    the training generator's seed (and of a rank's ``data`` index, when it
    is not 0)."""
    key = (int(seed), 1) if not data_index else (int(seed), 1, int(data_index))
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def train_seed(seed: int, data_index: int = 0) -> int:
    """Seed of the training generator: ``config.seed`` on one device and on
    the ranks of ``data`` index 0, a stream of its own on every other data
    index (ranks that share a data index draw the same)."""
    if not data_index:
        return int(seed)
    return int(np.random.SeedSequence((int(seed), 2, int(data_index))).generate_state(1)[0])


def build_model(config, device, **kwargs) -> torch.nn.Module:
    """The model that ``config`` describes, on ``device``, warm-started
    where the model has a ``warm_start``: what the trainer builds when no
    model is handed in. ``kwargs`` override ``method.model_kwargs``."""
    model_class = NAME2MODEL[config.model.model_class]
    kwargs = {**dict(config.method.model_kwargs), **kwargs}
    kwargs.setdefault("compute_dtype", (config.get("precision") or {}).get("compute_dtype"))
    model = model_class.from_config(config.model, device=device, **kwargs)
    if hasattr(model, "warm_start"):
        model.warm_start()
    return model


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
        self.config = update_config(default_trainer_config(), config)
        cfg = self.config
        self.setup_parallel(device)
        prec = cfg.get("precision") or {}
        if DTYPES[prec.get("param_dtype")] != torch.float32:
            raise ValueError("precision.param_dtype must be float32 (master weights)")
        self.compute_dtype = DTYPES[prec.get("compute_dtype")]
        self.verbosity = cfg.verbosity
        self.seed = int(cfg.seed)
        torch.manual_seed(self.seed)
        data_index = self.coords["data"]
        self.generator = torch.Generator(self.device).manual_seed(
            train_seed(self.seed, data_index))
        self.eval_generator = torch.Generator(self.device).manual_seed(
            eval_seed(self.seed, data_index))

        self.print_v(yaml.safe_dump(to_plain_dict(cfg), default_flow_style=False), verbosity=0)
        self.checkpoint_dir = os.path.join(cfg.dirs.checkpoint_dir, cfg.savestring)
        if self.is_main_process:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.init_logging()
        self._preempt_flag = False
        self._resume_step = 0

        self.set_dataset(dataset)
        self.set_model(model)
        self.get_model_inputs()
        self.build_dataloaders()
        self.print_v("Building optimizers", verbosity=0)
        grad_accum = int(cfg.optimizer.get("gradient_accumulation_steps", 1) or 1)
        self.grad_accum = grad_accum
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.trainable_names = [n for n, _ in named]
        self.trainable = trainable = [p for _, p in named]
        self.grad_clip_norm = float(cfg.optimizer.get("grad_clip_norm") or 0.0)
        self.grad_norm: Optional[torch.Tensor] = None   # before the last update's clip
        self.tp_split = {id(p) for n, p in named if n in self.plan.tp_dims}
        self.optimizer, self.schedule = build_optimizer(
            trainable, cfg.optimizer,
            steps_per_epoch=len(self.train_dataloader),
            num_epochs=int(cfg.training.num_epochs),
        )
        # training.chain_steps on the card, in one process or under NCCL:
        # captured steps, whose gradients stay at fixed addresses (gloo's
        # collectives run on the host: its ranks run the slots eagerly)
        self.chain_steps = max(1, int(cfg.training.get("chain_steps", 1) or 1))
        self.captured = (self.chain_steps > 1 and self.device.type == "cuda"
                         and self.backend in (None, "nccl"))
        self.graphs: Dict[tuple, TrainStepGraph] = {}
        self.n_updates = 0      # optimizer updates (the schedule's count)
        self.n_micro = 0        # train steps (micro-batches)
        self.metric_kwargs = dict(cfg.method.metric_kwargs)
        self.metric_lag = int(cfg.training.get("metric_lag", 4) or 1)
        self.metric_fns = metric_fns or {}
        self.eval_metric_fns = eval_metric_fns or {}
        self.eval_history: List[Dict[str, Any]] = []
        self.host_batches = 0   # batches copied from the host (to_device)
        self.batch_cache: Optional[DeviceBatchCache] = None
        if cfg.training.get("cache_device_batches"):
            self.batch_cache = DeviceBatchCache(
                self.seed, partial(self.to_device, every_row=True),
                lambda msg: self.print_v(msg, verbosity=1))
        n_params = sum(p.numel() for p in trainable)
        self.print_v(f"Model number of trainable parameters: {n_params:,}", verbosity=0)

    # ------------------------------------------------------------- plumbing

    def setup_parallel(self, device) -> None:
        """Join the process group when the config or the launcher asks for
        one, and build the mesh over it (``mesh``, ``mesh_sizes``, this
        rank's ``coords``); without a group the trainer runs on one device
        and every axis must be 1."""
        import torch.distributed as dist

        par = self.config.get("parallelism") or {}
        sizes = {k: int(par.get(k, -1 if k == "data" else 1)) for k in pmesh.AXES}
        if (par.get("multihost") or process.launcher_env()) and not dist.is_initialized():
            process.init_process(device)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.backend = dist.get_backend() if self.distributed else None
        if not self.distributed:
            try:
                self.mesh_sizes = pmesh.mesh_shape(1, **sizes)
            except ValueError as err:
                raise ValueError(f"{err}: no process group is up; start the ranks with "
                                 "torchrun --nproc-per-node N -m llm_bci_tpu_torch.main") from err
            self.device = resolve_device(device)
            self.mesh, self.coords, self.is_main_process = None, dict.fromkeys(pmesh.AXES, 0), True
        else:
            self.device = process.rank_device(device)
            self.mesh = pmesh.make_mesh(**sizes, device_type=self.device.type)
            self.mesh_sizes = dict(zip(pmesh.AXES, self.mesh.mesh.shape))
            self.coords = {a: self.mesh.get_local_rank(a) for a in pmesh.AXES}
            self.is_main_process = dist.get_rank() == 0
        self.plan = tdist.Plan()
        self._batch_split = False
        self._seq_shard: Optional[SequenceShard] = None

    def print_v(self, *args, verbosity: int = 3) -> None:
        if verbosity >= self.verbosity and self.is_main_process:
            print(*args, flush=True)

    def init_logging(self) -> None:
        """Weights & Biases (``log_to_wandb``; a sweep's values update the
        config) and a TensorBoard writer under ``dirs.log_dir``, each
        imported here and skipped when its package is missing."""
        cfg = self.config
        self.wandb = None
        self.writer = None
        if not self.is_main_process:
            return
        if cfg.get("log_to_wandb"):
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=cfg.get("wandb_project"))
                self.config = update_config(
                    self.config, config_from_kwargs(dict(wandb.config), convert=False))
            except ImportError:
                self.print_v("wandb not available; disabling", verbosity=0)
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

    def set_dataset(self, dataset) -> None:
        """The dataset handed in; a ``str`` is a JSON file. ``None`` takes
        ``data.hf_dataset_name`` (``datasets`` imported here) or
        ``data.json_dataset_name``."""
        if dataset is None:
            data_cfg = self.config.data
            if data_cfg.get("hf_dataset_name"):
                from datasets import load_dataset

                dataset = load_dataset(data_cfg.hf_dataset_name)
            elif data_cfg.get("json_dataset_name"):
                dataset = data_cfg.json_dataset_name
            else:
                raise ValueError("No dataset provided")
        if isinstance(dataset, str):
            with open(dataset) as f:
                dataset = json.load(f)
        self.dataset = dataset

    def set_model(self, model) -> None:
        """The model handed in, or :func:`build_model`'s; with a process
        group, cut and sharded by the plan (``training/distributed.py``)."""
        if model is None:
            model = build_model(self.config, self.device)
        self.model = model.to(self.device)
        if self.distributed:
            par = self.config.get("parallelism") or {}
            self.plan = tdist.apply_plan(self.model, self.mesh,
                                         int(par.get("fsdp_min_size", 1 << 20)))

    def get_model_inputs(self) -> None:
        """Batch columns that go to the model: the parameters of its
        ``forward``."""
        sig = inspect.signature(type(self.model).forward)
        skip = {"self", "generator", "masker_overrides", "seq_shard", "batch_group"}
        self.model_inputs = [p for p in sig.parameters if p not in skip]
        self._takes_batch_group = "batch_group" in sig.parameters

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

    def batch_layout(self, batch: Dict[str, Any]) -> tuple:
        """This rank's part of a global host batch, ``(start, stop, shard,
        batch_group)``, and the step state that :meth:`backward` and
        :meth:`global_outputs` read (``_batch_split``, ``_seq_shard``). With
        several ``data`` ranks the rows ``start:stop`` are the rank's
        (``parallel/mesh.py::batch_rows``; a batch the axis does not divide
        is held whole). With several ``sp`` ranks and a time dim that ``sp``
        divides, ``shard`` is the model's ``sequence_layout`` for the rank
        (its tokens' bins and their halo); an indivisible time dim (or a
        batch without ``spikes``) is ``None``: the ``sp`` ranks compute the
        same, as the JAX trainer keeps such a key whole. ``batch_group`` is
        the group whose ranks' parts make up the global batch: ``data x
        sp``, ``sp`` or ``data``, whichever cut this batch (``None`` when
        none did)."""
        arrays = [v for v in batch.values() if isinstance(v, np.ndarray)]
        n = arrays[0].shape[0] if arrays else 0
        start, stop = pmesh.batch_rows(n, self.mesh_sizes["data"], self.coords["data"])
        split = self._batch_split = stop - start < n
        shard = None
        n_sp = self.mesh_sizes["sp"]
        spikes = batch.get(SP_KEYS[0])
        if n_sp > 1 and isinstance(spikes, np.ndarray) and spikes.shape[1] % n_sp == 0:
            shard = self.model.sequence_layout(spikes.shape[1], n_sp, self.coords["sp"])
            shard = shard.with_group(self.mesh["sp"].get_group())
        self._seq_shard = shard
        # FSDP2's replicate dim is data x sp (parallel/mesh.py::fsdp_mesh)
        batch_group = (self.plan.dp_mesh.get_group(0) if split
                       else None if shard is None else shard.group)
        return start, stop, shard, batch_group

    def _with_layout(self, dev: Dict[str, Any], shard, batch_group) -> Dict[str, Any]:
        """``dev`` with the layout entries the model takes."""
        if shard is not None:
            dev["seq_shard"] = shard
        if self._takes_batch_group:
            dev["batch_group"] = batch_group
        return dev

    def to_device(self, batch: Dict[str, Any], out: Optional[Dict[str, Any]] = None,
                  every_row: bool = False) -> Dict[str, Any]:
        """Numpy columns -> tensors on the device (other columns stay out):
        this rank's part of the global batch (:meth:`batch_layout`), each
        key that the rank's ``seq_shard`` gives a range cut to it, read from
        the host batch that every rank holds; the layout goes to the model
        as ``seq_shard`` and ``batch_group``. float64 columns (a JSON
        dataset's lists) arrive as float32, as JAX without 64-bit mode places
        them. With ``out`` (a step graph's slots) each tensor is copied into
        ``out``'s. With ``every_row`` the tensors alone, of every row of the
        batch in the rank's time range: what the device batch pool keeps
        (:meth:`pooled_batch` cuts the rank's rows from it)."""
        self.host_batches += 1
        start, stop, shard, batch_group = self.batch_layout(batch)
        if every_row:
            start, stop = 0, None
        dev: Dict[str, Any] = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                continue
            v = (v.astype(np.float32) if v.dtype == np.float64 else v)[start:stop]
            if shard is not None and k in shard.slices:
                lo, hi = shard.slices[k]
                v = v[:, lo:hi]
            v = torch.from_numpy(np.ascontiguousarray(v))
            dev[k] = (v.to(self.device, non_blocking=True) if out is None
                      else out[k].copy_(v, non_blocking=True))
        return dev if every_row else self._with_layout(dev, shard, batch_group)

    def pooled_batch(self, columns: Dict[str, torch.Tensor], batch: Dict[str, Any],
                     idx: Optional[torch.Tensor] = None, out: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """This rank's device batch from the pool's device ``columns``
        (``to_device(..., every_row=True)``'s form): the rows ``idx`` of
        them (a device index, the global batch's rows in order), or all of
        them; the rank's rows cut by the layout of ``batch``, the host
        arrays of the same global batch. Equal, bit for bit, to
        :meth:`to_device` of ``batch``. With ``out``, written into its
        tensors."""
        start, stop, shard, batch_group = self.batch_layout(batch)
        rows = None if idx is None else idx[start:stop]
        dev: Dict[str, Any] = {}
        for k, col in columns.items():
            if rows is not None:
                dev[k] = (torch.index_select(col, 0, rows) if out is None
                          else torch.index_select(col, 0, rows, out=out[k]))
            else:
                dev[k] = col[start:stop] if out is None else out[k].copy_(col[start:stop])
        return self._with_layout(dev, shard, batch_group)

    def autocast(self):
        """``torch.autocast`` to ``precision.compute_dtype`` (off for float32)."""
        return torch.autocast(
            self.device.type, dtype=self.compute_dtype,
            enabled=self.compute_dtype != torch.float32,
        )

    def batches(self, loader, epoch: Optional[int] = None):
        """``(source, model_inputs, unused_inputs)`` for each batch of a pass
        over ``loader``: through the device-resident pool with
        ``training.cache_device_batches`` (``training/batch_cache.py``),
        else ``source`` is ``None`` (the host arrays are copied at the step)."""
        if self.batch_cache is not None:
            yield from self.batch_cache.batches(loader, epoch)
            return
        for model_inputs, unused_inputs in loader:
            yield None, model_inputs, unused_inputs

    def device_batch(self, source, model_inputs: Dict[str, Any],
                     out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """This rank's device batch of an item of :meth:`batches`; with
        ``out`` (a step graph's slots) written into its tensors. Sets the
        step state of its layout (:meth:`batch_layout`) whatever its
        source."""
        if source is None:
            return self.to_device(model_inputs, out=out)
        if isinstance(source, PoolRows):
            return self.pooled_batch(source.columns, model_inputs, source.idx, out)
        return self.pooled_batch(source, model_inputs, out=out)

    @staticmethod
    def batch_signature(source, model_inputs: Dict[str, Any]) -> tuple:
        """The signature (keys, shapes, dtypes) of an item of :meth:`batches`:
        of its host arrays when it streams, else of its pool rows (every
        row of the global batch, the rank's time range)."""
        if source is None:
            return batch_signature(model_inputs)
        if isinstance(source, PoolRows):
            return batch_signature(source.signature_batch())
        return batch_signature(source)

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
        split = self._batch_split
        update = (self.n_micro + 1) % self.grad_accum == 0
        outputs = self.backward(dev_batch, update)
        self._advance(update)
        return self.global_outputs(outputs, split, gather=bool(self.metric_fns))

    def backward(self, dev_batch: Dict[str, Any], update: bool) -> Dict[str, Any]:
        """The device work of a train step up to the update (what a step
        graph captures): forward and backward, and where the step closes an
        update the clip. Returns the rank's outputs, detached."""
        self.model.train()
        split = self._batch_split
        with self.autocast():
            out = self.model(**dev_batch, generator=self.generator)
        # The gradient of the summed loss, as the JAX trainer takes it; the
        # micro-batch gradients of one update are averaged (optax.MultiSteps).
        # FSDP2 averages the gradients of the (data x sp, fsdp) ranks: a rank
        # that holds 1/data of the rows scales its loss by data, and one whose
        # loss is the part of its time shard by sp, so that the average is
        # the global batch's gradient. Where every sp rank holds the whole
        # loss, the collectives' backward sums make up the sp.
        loss = out.loss / self.grad_accum
        if split:
            loss = loss * self.mesh_sizes["data"]
        if self._seq_shard is not None and self.model.sequence_outputs()[1]:
            loss = loss * self.mesh_sizes["sp"]
        loss.backward()
        if update and self.grad_clip_norm:
            self.grad_norm = clip_by_global_norm(
                self.trainable, self.grad_clip_norm, self.tp_split,
                fsdp_group=self.plan.fsdp_group, tp_group=self.plan.tp_group)
        return {k: (v.detach() if torch.is_tensor(v) else v) for k, v in out.to_dict().items()}

    def _advance(self, update: bool) -> None:
        """The host's step counts after a step, and the AdamW update where it
        closes one (eager: its learning rate and bias corrections are host
        floats, so a chained step's update is the single step's)."""
        self.n_micro += 1
        if update:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.n_updates)
            self.optimizer.step()
            # a captured step's gradients stay at their addresses
            self.optimizer.zero_grad(set_to_none=not self.captured)
            self.n_updates += 1

    def chain(self, items: List[tuple]) -> Any:
        """Train steps on ``items`` of :meth:`batches` (of one signature),
        yielding each step's outputs as it is enqueued. Each goes through
        the :class:`TrainStepGraph` of its signature and of whether it
        closes an update (made at its first step): the batch into its
        slots, the graph's outputs copied out (over the global batch, as
        :meth:`train_step` gives them), then the update."""
        for source, model_inputs, _ in items:
            update = (self.n_micro + 1) % self.grad_accum == 0
            key = (self.batch_signature(source, model_inputs), update)
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.graphs[key] = TrainStepGraph(
                    partial(self.backward, update=update), self.generator,
                    capture=self.captured)
                graph.adopt(self.device_batch(source, model_inputs))
            else:
                self.device_batch(source, model_inputs, out=graph.slots)
            split = self._batch_split
            if graph.grads:
                self._attach_grads(graph.grads)
            outputs = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in graph().items()}
            if graph.graph is not None and graph.grads is None:
                # the tensors a replay accumulates the gradients into
                graph.grads = [(p, p.grad) for p in self.trainable if p.grad is not None]
            self._advance(update)
            yield self.global_outputs(outputs, split, gather=bool(self.metric_fns))

    @staticmethod
    def _attach_grads(grads: List[tuple]) -> None:
        """Make each ``(parameter, buffer)``'s gradient the buffer a step
        graph accumulates into again, with the value the parameter's
        gradient has now (zero where it was freed): anything that replaced
        a gradient since the capture changes no result."""
        for p, buf in grads:
            if p.grad is not buf:
                if p.grad is None:
                    buf.zero_()
                else:
                    buf.copy_(p.grad)
                p.grad = buf

    def free_graphs(self) -> None:
        """Free the step graphs (their pools hold a step's activations); a
        run of captured steps also frees its gradients outside an
        accumulation window."""
        if self.captured:
            torch.cuda.synchronize(self.device)
        for graph in self.graphs.values():
            graph.free()
        self.graphs.clear()
        if self.captured and self.n_micro % self.grad_accum == 0:
            self.optimizer.zero_grad(set_to_none=True)

    def global_outputs(self, outputs: Dict[str, Any], split: bool, gather: bool
                       ) -> Dict[str, Any]:
        """A step's outputs over the global batch when the rank held a share
        of its rows or of their time axis: 0-dim tensors (``loss``,
        ``n_examples``) summed over ``sp`` where they are the rank's part
        (``model.sequence_outputs()``), then over ``data``; with ``gather``
        the time-dim outputs gathered over ``sp`` and the batch-dim tensors
        over ``data``, in rank order (what a metric fn reads)."""
        if self._seq_shard is not None:
            time_dims, summed = self.model.sequence_outputs()
            outputs = whole_sequence_outputs(outputs, self._seq_shard, time_dims, summed,
                                             gather)
        if not split:
            return outputs
        return tdist.global_outputs(outputs, self.mesh["data"].get_group(), gather)

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
        for source, model_inputs, unused_inputs in self.batches(loader):
            batch = self.device_batch(source, model_inputs)
            with self.autocast():
                out = self.model(**batch, generator=self.eval_generator)
            readback.add((model_inputs, unused_inputs),
                         self.global_outputs(out.to_dict(), self._batch_split,
                                             gather=bool(metric_fns)))
        readback.flush()
        total_examples = float(sum(examples))
        total_loss = float(sum(losses))
        avg_loss = total_loss / total_examples if total_examples > 0 else 0.0
        return avg_loss, {k: (sum(v) / len(v) if v else 0.0) for k, v in metrics.items()}

    # ----------------------------------------------------------------- train

    def train(self) -> None:
        """Train to ``max_steps`` (or ``num_epochs``' worth of steps). After
        :meth:`resume_from` the step count continues from the restored step,
        which counts against the same budget; the interrupted epoch's order is
        derived again from ``(seed, epoch)`` and its consumed batches skipped.
        With ``training.chain_steps: K > 1``, K batches of one signature run
        as a chain (:meth:`chain`) wherever no boundary falls inside it."""
        cfg = self.config
        self.print_v(f"Starting run {cfg.savestring}", verbosity=0)
        max_steps = cfg.training.get("max_steps")
        eval_every = cfg.training.get("eval_every")
        save_every = cfg.training.get("save_every")
        halt_on_nonfinite = bool(cfg.training.get("halt_on_nonfinite", False))
        preempt_sync = max(1, int(cfg.training.get("preemption_sync_every", 10) or 1))
        steps_per_epoch = max(len(self.train_dataloader), 1)
        n_epochs = int(cfg.training.num_epochs)
        budget = int(max_steps) if max_steps else steps_per_epoch * n_epochs
        step = self._resume_step + 1
        self._resume_step = 0
        if step > budget:
            self.print_v(f"Nothing to do: resumed at step {step - 1} with a budget of "
                         f"{budget} steps", verbosity=1)
            return
        start_epoch = (step - 1) // steps_per_epoch + 1
        profile_cfg = cfg.get("profile") or {}
        profiler = None
        K = self.chain_steps
        if K > 1 and self.distributed:
            how = ("captured once a batch signature and replayed" if self.captured else
                   "run eagerly on the step graphs' slots (gloo's collectives run on the host "
                   "and cannot be captured)" if self.device.type == "cuda" else
                   "run eagerly on the step graphs' slots (CPU)")
            self.print_v(f"chain_steps={K} under a {self.backend} process group: a chain's "
                         f"steps are {how}", verbosity=0)

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

        def chain_cap(g: int) -> int:
            """The longest chain from step ``g`` whose inside crosses no eval,
            save, profile or budget boundary (one may be its last step)."""
            cap = min(K, budget - g + 1)
            for cadence in (eval_every, save_every):
                if cadence:
                    cap = min(cap, int(cadence) - (g - 1) % int(cadence))
            if profile_cfg and profile_cfg.get("start_step") is not None:
                start = int(profile_cfg["start_step"])
                if g < start:
                    cap = min(cap, start - g)
                elif g < start + int(profile_cfg.get("num_steps", 5)):
                    cap = 1     # the profiled steps run singly
            return max(cap, 1)

        def after_step(g: int) -> bool:
            """Preemption, eval, save and budget bookkeeping of step ``g``;
            True when training stops."""
            nonlocal train_metrics, window
            preempted = self._preempt_flag
            if self.distributed:
                # every rank must stop (and save, a collective) at one
                # step: agree every preemption_sync_every steps
                preempted = g % preempt_sync == 0 and process.any_rank(self._preempt_flag)
            if preempted:
                # after a chain the state is that of its last step: the tag
                # says the step the state holds
                self.print_v(f"Preemption: saving at step {self.n_micro} and stopping",
                             verbosity=0)
                readback.flush()
                self.save_checkpoint(f"STEP{self.n_micro}")
                self._preempt_flag = False
                return True
            if eval_every and g % eval_every == 0:
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
                    "step": g, "train_avg_loss": train_avg,
                    "train_avg_metrics": train_avg_metrics, "test_avg_loss": test_loss,
                    "test_avg_metrics": test_metrics, "samples_per_sec": throughput,
                })
                self.print_v(
                    f"savestring={cfg.savestring} global_step={g}:\n"
                    f"train_avg_loss={train_avg} train_avg_metrics={train_avg_metrics}\n"
                    f"test_avg_loss={test_loss} test_avg_metrics={test_metrics}\n"
                    f"throughput={throughput:.1f} samples/s (train steps and metric fns, "
                    f"device {self.device})",
                    verbosity=1,
                )
                self.log_eval(g, train_avg, train_avg_metrics, test_loss, test_metrics,
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
                        f"Non-finite loss at step {g} (train={train_avg}, "
                        f"test={test_loss}); halting. Resume from the last finite "
                        "checkpoint with training.resume=true.")
            if save_every and g % save_every == 0:
                readback.flush()
                self.save_checkpoint(f"STEP{g}")
            if g >= budget:
                readback.flush()
                self.print_v("Reached max_steps" if max_steps else "Step budget done",
                             verbosity=1)
                return True
            return False

        previous_handler = None
        if bool(cfg.training.get("save_on_preemption", True)):
            try:
                previous_handler = signal.signal(signal.SIGTERM,
                                                 lambda signum, frame: self.request_preemption())
            except ValueError:     # not the main thread: request_preemption() remains
                previous_handler = None
        try:
            for epoch in range(min(start_epoch, n_epochs), n_epochs + 1):
                self.print_v(f"Epoch {epoch}", verbosity=1)
                self.train_dataloader.set_epoch(
                    epoch, skip_batches=(step - 1) % steps_per_epoch)
                stream = self.batches(self.train_dataloader, epoch)
                buf: List[tuple] = []
                exhausted = False
                while True:
                    want = K if K > 1 and chain_cap(step) >= K else 1
                    while len(buf) < want and not exhausted:
                        item = next(stream, None)
                        exhausted = item is None
                        if not exhausted:
                            buf.append(item)
                    if not buf:
                        break
                    if want > 1 and len(buf) >= K and len(
                            {self.batch_signature(*item[:2]) for item in buf[:K]}) == 1:
                        # only exact-K groups chain; shorter runs take the single step
                        group, buf = buf[:K], buf[K:]
                        for j, outputs in enumerate(self.chain(group)):
                            readback.add((step + j, group[j][1], group[j][2]), outputs)
                        for _ in group:
                            if after_step(step):
                                return
                            step += 1
                        continue

                    source, model_inputs, unused_inputs = buf.pop(0)
                    if profile_cfg and step == profile_cfg.get("start_step"):
                        profiler = self.start_profiler()
                    if K > 1:
                        step_graph.count_eager_step()
                    outputs = self.train_step(self.device_batch(source, model_inputs))
                    readback.add((step, model_inputs, unused_inputs), outputs)
                    if profiler is not None and step == (
                            profile_cfg.get("start_step") + profile_cfg.get("num_steps", 5) - 1):
                        self.stop_profiler(profiler, profile_cfg)
                        profiler = None
                    if after_step(step):
                        return
                    step += 1
            readback.flush()
            self.print_v("Training done", verbosity=1)
        finally:
            if profiler is not None:
                self.stop_profiler(profiler, profile_cfg)
            if self.writer is not None:
                self.writer.flush()
            if previous_handler is not None:
                signal.signal(signal.SIGTERM, previous_handler)
            self.free_graphs()

    def start_profiler(self):
        """A started ``torch.profiler.profile``: CPU activities, and CUDA ones
        on the card."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def stop_profiler(self, profiler, profile_cfg) -> str:
        """Synchronise, stop, and write the Chrome trace to ``profile.dir``;
        returns its path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out_dir = profile_cfg.get("dir") or "profiles"
        os.makedirs(out_dir, exist_ok=True)
        start = int(profile_cfg.get("start_step"))
        path = os.path.join(out_dir, f"{self.config.savestring}_steps{start}-{self.n_micro}"
                                     ".trace.json")
        profiler.export_chrome_trace(path)
        self.print_v(f"Profiler trace written to {path}", verbosity=1)
        return path

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
        blobs and configs), the optimizer's ``state_dict`` and the config;
        and the full train state of the current step
        (:meth:`save_train_state`). With several ranks, every rank takes part
        in gathering the whole state and rank 0 writes it, in the format of
        one device."""
        path = os.path.join(self.checkpoint_dir, tag)
        self.print_v(f"Saving checkpoint to {path}", verbosity=1)
        state = self.whole_state()
        if self.is_main_process:
            os.makedirs(path, exist_ok=True)
            include_frozen = bool(self.config.training.get("component_blobs", True))
            if hasattr(self.model, "save_checkpoint"):
                self.model.save_checkpoint(path, include_frozen=include_frozen,
                                           state=state["model"])
                self.model.save_config(path)
            else:
                torch.save(state["model"], os.path.join(path, "model.pt"))
            torch.save(state["optimizer"]["state_dict"], os.path.join(path, "optimizer.pt"))
            with open(os.path.join(path, "trainer_config.yaml"), "w") as f:
                yaml.safe_dump(to_plain_dict(self.config), f)
        self.save_train_state(state)

    def whole_state(self) -> Dict[str, Any]:
        """The model's ``state_dict``, the optimizer's (by parameter name)
        and the partial gradients of an open accumulation window, as whole
        tensors: on one device the live ones; with several ranks gathered
        (a collective), kept on rank 0 only."""
        open_window = self.n_micro % self.grad_accum
        if not self.distributed:
            return {
                "model": self.model.state_dict(),
                "optimizer": checkpoint.optimizer_state(self.optimizer, self.trainable_names),
                "grads": {n: p.grad for n, p in zip(self.trainable_names, self.trainable)
                          if p.grad is not None} if open_window else {},
            }
        keep = self.is_main_process
        grads = {}
        if open_window:
            for n, p in zip(self.trainable_names, self.trainable):
                if p.grad is not None:
                    g = tdist.full_tensor(p.grad, self.plan.tp_dims.get(n), self.plan)
                    if keep:
                        grads[n] = g.cpu()
        return {
            "model": tdist.model_full_state(self.model, self.plan, keep),
            "optimizer": tdist.optimizer_full_state(self.optimizer, self.trainable_names,
                                                    self.plan, keep),
            "grads": grads,
        }

    def train_state_dir(self) -> str:
        return os.path.join(self.checkpoint_dir, "train_state")

    def frozen_state_keys(self) -> set:
        """The model's leaves that do not train: parameters without a
        gradient, and the int8 base's ``kernel`` / ``kernel_scale`` buffers."""
        frozen = {n for n, p in self.model.named_parameters() if not p.requires_grad}
        frozen |= {n for n, _ in self.model.named_buffers()
                   if n.endswith((".kernel", ".kernel_scale"))}
        return frozen

    def save_train_state(self, state: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """``train_state/<step>/`` (``training/checkpoint.py``): the model's
        ``state_dict`` (without its frozen leaves under
        ``training.component_blobs: false``), the optimizer's, the update and
        step counts, both generators' states and the partial gradients of an
        open accumulation window; and ``resume_meta.json``, the dataloader
        geometry that a mid-epoch resume assumes. With several ranks the
        state is the gathered whole one (``state``, or :meth:`whole_state`),
        written by rank 0 with rank 0's generators, and every ``data``
        index's generator states beside them under ``rank_generators``; the
        ranks wait for the write. Returns the directory (``None`` on the
        other ranks)."""
        state = self.whole_state() if state is None else state
        rank_generators = {}
        if self.distributed:
            states = [self.generator.get_state(), self.eval_generator.get_state()]
            gathered = process.all_gather_host(
                np.concatenate([s.numpy() for s in states]))
            coords = [pmesh.coordinates(r, self.mesh_sizes) for r in range(len(gathered))]
            n = states[0].numel()
            for c, g in zip(coords, gathered):
                rank_generators[c["data"]] = (torch.from_numpy(g[:n].copy()),
                                              torch.from_numpy(g[n:].copy()))
        path = None
        if self.is_main_process:
            model_state = state["model"]
            if not bool(self.config.training.get("component_blobs", True)):
                frozen = self.frozen_state_keys()
                model_state = {k: v for k, v in model_state.items() if k not in frozen}
            trainer_state = {
                "n_updates": self.n_updates, "n_micro": self.n_micro,
                "generator": self.generator.get_state(),
                "eval_generator": self.eval_generator.get_state(), "grads": state["grads"],
            }
            if rank_generators:
                trainer_state["rank_generators"] = rank_generators
            path = checkpoint.save_train_state(self.train_state_dir(), self.n_micro, {
                "model": model_state, "optimizer": state["optimizer"],
                "trainer": trainer_state,
            })
            meta = {
                "steps_per_epoch": len(self.train_dataloader),
                "train_batch_size": int(self.config.training.train_batch_size),
                "train_dataset_len": len(self.train_dataloader.dataset),
            }
            with open(os.path.join(self.checkpoint_dir, "resume_meta.json"), "w") as f:
                json.dump(meta, f)
        if self.distributed:
            import torch.distributed as dist

            dist.barrier()
        return path

    def resume_from(self, directory: Optional[str] = None) -> int:
        """Restore the newest full train state under ``directory`` (default
        ``train_state/`` of this run) and return its step; the next
        :meth:`train` continues from it. Raises ``FileNotFoundError`` when
        there is none; warns when the dataloader geometry differs from the
        saved run's, since the mid-epoch skip is derived from it."""
        directory = directory or self.train_state_dir()
        meta_path = os.path.join(os.path.dirname(os.path.abspath(directory)),
                                 "resume_meta.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = {}
            saved_spe = meta.get("steps_per_epoch")
            live_spe = len(self.train_dataloader)
            if saved_spe is not None and int(saved_spe) != live_spe:
                self.print_v(
                    "WARNING: resuming with a different dataloader geometry than the "
                    f"checkpointed run: steps_per_epoch {saved_spe} (saved: batch_size="
                    f"{meta.get('train_batch_size')}, dataset_len="
                    f"{meta.get('train_dataset_len')}) vs {live_spe} now. The mid-epoch "
                    "fast-forward derives skip_batches from steps_per_epoch, so the resumed "
                    "run will NOT replay the interrupted epoch's exact batches — restore the "
                    "original batch size/dataset for a deterministic resume.",
                    verbosity=3,
                )
        step, parts = checkpoint.load_train_state(directory)
        state = parts["trainer"]
        generators = (state.get("generator"), state.get("eval_generator"))
        grads = state.get("grads") or {}
        if not self.distributed:
            checkpoint.overlay_model_state(self.model, parts["model"])
            checkpoint.overlay_optimizer_state(self.optimizer, self.trainable_names,
                                               self.trainable, parts["optimizer"])
        else:
            # every rank read the whole state: cut it to this rank's share
            plan = self.plan
            target = {k: torch.empty(tdist.whole_shape(v, plan.tp_dims.get(k), plan),
                                     dtype=v.dtype, device="meta")
                      for k, v in self.model.state_dict().items()}
            tdist.load_model_full_state(
                self.model, checkpoint.fit_model_state(parts["model"], target), plan)
            checkpoint.overlay_optimizer_state(
                self.optimizer, self.trainable_names, self.trainable,
                tdist.optimizer_local_state(parts["optimizer"], self.trainable_names,
                                            self.trainable, plan))
            generators = state.get("rank_generators", {}).get(self.coords["data"], generators)
            grads = {n: tdist.local_like(grads[n], p, plan.tp_dims.get(n), plan)
                     for n, p in zip(self.trainable_names, self.trainable) if n in grads}
        self.n_updates, self.n_micro = int(state["n_updates"]), int(state["n_micro"])
        checkpoint.restore_generator(self.generator, generators[0], "generator")
        checkpoint.restore_generator(self.eval_generator, generators[1], "eval generator")
        for name, p in zip(self.trainable_names, self.trainable):
            g = grads.get(name)
            p.grad = None if g is None else g.to(device=p.device, dtype=p.dtype)
        self._resume_step = int(step)
        return int(step)

    @contextlib.contextmanager
    def unsharded(self):
        """Within the block every FSDP2 group of the model holds its whole
        parameters, so that a method other than ``forward`` (``generate``)
        can run; resharded after. A no-op on one device."""
        from torch.distributed.fsdp import FSDPModule

        groups = [m for m in self.model.modules() if isinstance(m, FSDPModule)]
        for m in groups:
            m.unshard()
        try:
            yield self.model
        finally:
            for m in groups:
                m.reshard()
