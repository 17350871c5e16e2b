"""The training driver: the port's trainer built as its CLI builds it, one
``Trainer.train()`` call timed over a window, and the port's outputs checked
against the plain reference (``check.py``).

The window: ``train()`` runs the traffic's ``warmup_steps`` first (the
first steps, a step graph's capture, a pool's caching pass), all counted as
set-up; the window opens at a device synchronisation after the last of them
and closes when, ``seconds`` later, the trainer has been asked to stop (its
preemption request, with the save it makes disabled), has drained its lagged
readback and the device is synchronised again. Samples are the rows of the
steps after the warm-up that the readback consumed. A traced run profiles a
stretch of ``trace_steps`` steps, aligned to the trainer's chains, from the
middle of its window, and stops after it; the stretch before it, unprofiled,
gives the operations a second that ``step_mfu`` reads.

``run`` hands the harness a namespace: the end-to-end readings (``e2e``:
``samples``, ``window_s``, ``peak_bytes``, ``setup_s``), what a per-layer
metric may read (``layer``, a :class:`LayerContext`, traced runs only), the
compared numbers and what lies behind them, the device's readings and the
traced run's breakdown.
"""
from __future__ import annotations

import argparse
import copy
import gc
import math
import os
import resource
import shutil
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np

import check
import reference
import traffic as traffic_mod
import work
from reference import common
from reference import data as ref_data


class Window:
    """Hooks on one trainer: the step boundaries (its ``_advance``), the
    lagged readback's consumer and the train CER fn. Records what the check
    and the metrics need and opens, profiles and closes the window."""

    def __init__(self, trainer, run: dict, seconds: float, trace: bool, device, tmp: str):
        import torch

        self.torch = torch
        self.t = trainer
        self.cuda = device.type == "cuda"
        self.warmup = int(run["warmup_steps"])
        self.check_steps = int(run["check_steps"])
        self.follow_step = run.get("follow_step")
        self.trace_steps = int(run["trace_steps"])
        self.seconds, self.trace, self.tmp = float(seconds), bool(trace), tmp
        self.align = max(1, int(trainer.chain_steps))
        self.records: Dict[int, dict] = {}
        self.step_times: Dict[int, float] = {}
        self.cer: Dict[int, tuple] = {}
        self.snap: Dict[str, object] = {}
        self.t0 = self.t_end = self.t_unprofiled = None
        self.unprofiled_steps = (self.warmup, None)
        self.profiler, self.prof_start, self.stretch = None, None, None
        self.stopping = False
        self.counters0 = self.counters1 = None
        self._consuming: Optional[int] = None

    # ------------------------------------------------------------- hooks

    def install(self) -> None:
        advance = self.t._advance

        def hooked(update: bool) -> None:
            step = self.t.n_micro + 1
            if step == 1:
                self._hook_readback()
            self.before(step)
            advance(update)
            self.after(step)

        self.t._advance = hooked
        self.t.save_checkpoint = lambda tag: None    # the stop request saves nothing
        fn = self.t.metric_fns.get("CER")
        if fn is not None:
            def cer(model, model_inputs, unused_inputs, outputs, **kwargs):
                value = fn(model, model_inputs, unused_inputs, outputs, **kwargs)
                if self._consuming is not None and self._consuming <= self.check_steps:
                    self.cer[self._consuming] = (float(value), np.asarray(kwargs["prepared"]))
                return value

            cer.prepare = fn.prepare
            self.t.metric_fns = {**self.t.metric_fns, "CER": cer}

    def _hook_readback(self) -> None:
        rb = self.t.readback
        consume = rb.consume

        def hooked(ctx, outputs, loss, n, prepared):
            step, model_inputs, unused = ctx
            self.records[step] = {
                "loss": loss, "rows": int(len(model_inputs["spikes"])),
                "trials": [int(i) for i in np.asarray(unused["trial"]).reshape(-1)],
                "lengths": np.asarray(model_inputs["spikes_lengths"]).reshape(-1).tolist(),
            }
            self._consuming = step
            consume(ctx, outputs, loss, n, prepared)
            self._consuming = None

        rb.consume = hooked

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def counters(self) -> dict:
        from llm_bci_tpu_torch.training import step_graph

        return {"eager_steps": step_graph.EAGER_STEPS, "replays": step_graph.REPLAYS,
                "captures": step_graph.CAPTURES, "host_batches": self.t.host_batches,
                "pool_bytes": self.t.batch_cache.bytes if self.t.batch_cache else 0}

    def before(self, step: int) -> None:
        if step == 2:
            self.snap["grad2"] = self._norms([p.grad for p in self.t.trainable])
        if step == self.follow_step:
            self.snap["followed_grad"] = self._norms([p.grad for p in self.t.trainable])

    def after(self, step: int) -> None:
        torch = self.torch
        if step == 1:
            beta1 = self.t.optimizer.param_groups[0]["betas"][0]
            # a leaf the optimizer holds no moment of has no gradient for it
            moments = [self.t.optimizer.state.get(p, {}).get("exp_avg")
                       for p in self.t.trainable]
            self.snap["grad1"] = self._norms(moments) / (1.0 - beta1)
        if step == self.check_steps:
            self.snap["params_checked"] = [p.detach().to("cpu", copy=True)
                                           for p in self.t.trainable]
        if self.follow_step is not None and step == self.follow_step - 1:
            self.snap["params_before_followed"] = [p.detach().to("cpu", copy=True)
                                               for p in self.t.trainable]
        if step == self.warmup:
            self.sync()
            self.t0 = time.perf_counter()
            self.counters0 = self.counters()
            return
        if self.t0 is None or self.stopping:
            return
        now = time.perf_counter()
        self.step_times[step] = now
        if not self.trace:
            if now - self.t0 >= self.seconds:
                self.stop()
            return
        if self.profiler is None and now - self.t0 >= self.seconds / 2 and step % self.align == 0:
            from torch.profiler import ProfilerActivity, profile

            self.sync()
            self.t_unprofiled = time.perf_counter()
            self.unprofiled_steps = (self.warmup, step)
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.profiler = profile(activities=activities)
            self.profiler.start()
            self.prof_start = (step, time.perf_counter())
        elif self.profiler is not None and step == self.prof_start[0] + self.trace_steps:
            from stretch import load

            self.sync()
            window_s = time.perf_counter() - self.prof_start[1]
            self.profiler.stop()
            self.stretch = load(self.profiler, os.path.join(self.tmp, "stretch.json"), window_s,
                                self.trace_steps)
            self.profiler = None
            self.stretch.first_step = self.prof_start[0] + 1
            self.stop()

    def stop(self) -> None:
        self.stopping = True
        self.counters1 = self.counters()
        self.t.request_preemption()

    def _norms(self, tensors) -> "np.ndarray":
        torch = self.torch
        out = [torch.zeros((), device=p.device) if g is None else g.detach().float().norm()
               for g, p in zip(tensors, self.t.trainable)]
        return torch.stack(out).cpu().numpy().astype(np.float64)

    def close(self) -> None:
        self.sync()
        self.t_end = time.perf_counter()
        if self.counters1 is None:
            self.counters1 = self.counters()

    # ---------------------------------------------------------- readings

    def halves(self) -> Optional[List[float]]:
        """Samples a second in each half of the window (by step end times on
        the host clock): whether the rate is steady through it."""
        if not self.step_times or self.t_end is None:
            return None
        mid = self.t0 + (self.t_end - self.t0) / 2
        first = [s for s, t in self.step_times.items() if t <= mid]
        rows = lambda steps: sum(self.records[s]["rows"] for s in steps if s in self.records)  # noqa
        n1 = rows(first)
        n2 = rows([s for s in self.step_times if s not in first])
        return [n1 / (mid - self.t0), n2 / (self.t_end - mid)]

    def window_steps(self) -> List[int]:
        return sorted(s for s in self.records if s > self.warmup)

    def samples(self, first: int, last: Optional[int] = None) -> int:
        return sum(r["rows"] for s, r in self.records.items()
                   if s > first and (last is None or s <= last))


class LayerContext:
    """What a per-layer metric's reader may read: the profiled stretch, the
    port's counters over the window, the trained batches and the widths they
    were padded to, the configuration and its reference module, and
    ``work``'s arithmetic."""

    def __init__(self, window: Window, config: dict, traffic: dict, widths: Dict[str, int],
                 n_channels: int, n_outputs: int):
        self.work = work
        self.reference = reference.model_module(config)
        self.stretch = window.stretch
        self.config, self.traffic, self.widths = config, traffic, widths
        self.model = config["trainer"]["model"]
        self.method = config["method"]
        self.n_channels, self.n_outputs = n_channels, n_outputs
        c0, c1 = window.counters0 or {}, window.counters1 or {}
        self.counters = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
        self.window_steps = len(window.window_steps())
        # the stretch of the window before the profiler started: its batches
        # and its seconds on the host clock
        self.unprofiled_batches, self.unprofiled_s = [], None
        first, last = window.unprofiled_steps
        if window.t_unprofiled is not None and last is not None and last > first:
            self.unprofiled_batches = [window.records[s] for s in range(first + 1, last + 1)
                                       if s in window.records]
            self.unprofiled_s = window.t_unprofiled - window.t0
        self.stretch_batches = []
        if self.stretch is not None:
            s0 = self.stretch.first_step
            self.stretch_batches = [window.records[s] for s in
                                    range(s0, s0 + self.stretch.steps) if s in window.records]

    def kernel_ms_per_step(self, group: str) -> Optional[float]:
        if self.stretch is None or not self.stretch.steps:
            return None
        s = self.stretch.kernel_s(group)
        return None if s is None else s * 1e3 / self.stretch.steps


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Built:
    """A cell's trainer built for one seed, with what the check needs."""


def build(spec: dict, seed: int, dev) -> Built:
    """The cell's trainer as the port's CLI builds it (``main.build_trainer``
    on the configuration with the traffic's trainer settings, the trials
    handed in, the CER metric fns ``main`` attaches for ``ctc``), its
    trainable leaves set to the benchmark's weights of ``seed``."""
    import torch
    from llm_bci_tpu_torch import main as port_main

    b = Built()
    config, traffic = spec["config"], spec["traffic"]
    ref = reference.model_module(config)
    b.tmp = tempfile.mkdtemp(prefix="bench_port_")
    # no evals or saves in the window unless the traffic asks for them
    trainer_cfg = merge(config["trainer"], {
        "training": {"num_epochs": int(config["num_epochs"]), "eval_every": None,
                     "save_every": None, "max_steps": None}})
    trainer_cfg = merge(trainer_cfg, traffic.get("trainer", {}))
    trainer_cfg = merge(trainer_cfg, {
        "seed": int(seed), "verbosity": 2, "log_to_wandb": False,
        "dirs": {"checkpoint_dir": b.tmp, "log_dir": None}, "training": {"resume": False}})
    b.config = config = dict(config, trainer=trainer_cfg)
    b.traffic, b.limits = traffic, spec["limits"]
    method = config["method"]
    b.vocab = vocab = config.get("vocab") if method == "ctc" else None
    b.times = {"build": time.perf_counter()}
    b.trials = trials = traffic_mod.make_trials(config, traffic, seed, dev, vocab)
    b.times["trials"] = time.perf_counter()
    b.n_channels = int(trials["train"][0]["spikes"].shape[1])
    b.n_outputs = len(vocab) if vocab else b.n_channels
    if vocab:
        trainer_cfg["method"]["model_kwargs"]["vocab_size"] = len(vocab)

    args = argparse.Namespace(config_file=trainer_cfg, kwargs=None, device=str(dev))
    b.trainer = trainer = port_main.build_trainer(args, dataset=trials)
    b.times["trainer"] = time.perf_counter()
    if method == "ctc":
        train_cer, eval_cer = port_main.make_cer_fns(
            vocab, trainer_cfg["method"]["model_kwargs"]["blank_id"])
        trainer.metric_fns, trainer.eval_metric_fns = {"CER": train_cer}, {"CER": eval_cer}

    b.leaves = leaves = ref.param_spec(trainer_cfg["model"], b.n_channels, b.n_outputs)
    b.names = names = list(trainer.trainable_names)
    shapes = {n: tuple(p.shape) for n, p in zip(names, trainer.trainable)}
    if shapes != dict(leaves):
        raise RuntimeError("the program's trainable leaves are not the reference's: "
                           f"{sorted(set(shapes) ^ set(dict(leaves)))}")
    with torch.no_grad():
        weights = common.make_weights(leaves, seed, dev)
        for n, p in zip(names, trainer.trainable):
            p.copy_(weights[n])
    b.times["weights"] = time.perf_counter()
    return b


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, started: float,
        controls: Sequence[dict] = ()) -> SimpleNamespace:
    """One run of a training cell on ``dev``. Each of ``controls`` puts the
    reference in the program's place, at another precision or with a fault
    (``{"precision": "fp8"}``, ``{"half_batch": True}``, ``{"frozen": True}``),
    and its numbers go to ``controls``."""
    import torch

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    b = build(spec, seed, dev)
    config, traffic = b.config, b.traffic
    trainer, trials, names, leaves = b.trainer, b.trials, b.names, b.leaves
    method, tmp = config["method"], b.tmp
    n_channels, n_outputs = b.n_channels, b.n_outputs
    times = b.times
    del b

    window = Window(trainer, traffic["run"], seconds, trace, dev, tmp)
    window.install()
    trainer.train()
    window.close()
    peak = (torch.cuda.max_memory_allocated() if cuda
            else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)

    # the program's readings, then its state freed before the reference runs
    rec = window.records
    steps = {s: rec[s]["trials"] for s in range(1, window.check_steps + 1)}
    prog = {"losses": {s: rec[s]["loss"] for s in steps},
            "grad1": dict(zip(names, window.snap["grad1"].tolist())),
            "grads": {2: dict(zip(names, window.snap["grad2"].tolist()))}}
    checked = dict(zip(names, window.snap["params_checked"]))
    followed = None
    if window.follow_step is not None:
        k = int(window.follow_step)
        prog["followed"] = {"loss": rec[k]["loss"],
                            "grad": dict(zip(names, window.snap["followed_grad"].tolist()))}
        followed = {"step": k, "trials": rec[k]["trials"],
                    "params": dict(zip(names, window.snap["params_before_followed"]))}
    cer_ids = dict(window.cer)
    window_s = window.t_end - window.t0
    # where set-up goes: imports and start-up, trials, the trainer, weights, warm-up
    marks = [started, times["build"], times["trials"], times["trainer"], times["weights"],
             window.t0]
    setup_parts = dict(zip(("start", "trials", "trainer", "weights", "warmup"),
                           [b - a for a, b in zip(marks, marks[1:])]))
    window_halves = window.halves()
    win_steps = window.window_steps()
    e2e = SimpleNamespace(samples=window.samples(window.warmup), window_s=window_s,
                          peak_bytes=peak, setup_s=window.t0 - started)
    failed = sum(1 for s in win_steps if not math.isfinite(rec[s]["loss"]))
    widths = ref_data.pad_widths(trials)
    layer = (LayerContext(window, config, traffic, widths, n_channels, n_outputs)
             if trace else None)
    del trainer, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    p0 = common.make_weights(leaves, seed, dev)
    refr = check.follow(p0, trials, steps, config, seed, dev, followed=followed)
    prog["update"] = check.leaf_norms({n: checked[n].to(dev) - p0[n] for n in names})
    if method == "ctc" and cer_ids:
        prog["cer"] = {s: (v, check.reference_cer(ids, steps[s], trials))
                       for s, (v, ids) in cer_ids.items()}
    numbers = check.compare(prog, refr)
    control_numbers = []
    for control in controls:
        alt = check.follow(p0, trials, steps, config, seed, dev, followed=followed,
                           precision=control.get("precision", "fp32"),
                           half_batch=bool(control.get("half_batch")),
                           frozen=bool(control.get("frozen")))
        control_numbers.append({"control": control, "numbers": check.compare(alt, refr),
                                "details": check.details(alt, refr)})
    shutil.rmtree(tmp, ignore_errors=True)

    details = check.details(prog, refr)
    details["setup_parts_s"] = setup_parts
    details["padding_share"] = traffic_mod.padding_share(
        traffic, int(config["train_trials"]) + int(config["test_trials"]))
    if window_halves is not None:
        details["window_halves_samples_per_s"] = window_halves
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        st = layer.stretch
        device["busy_s"] = st.busy_s if st else None
        device["window_s"] = st.window_s if st else None
        breakdown = {"device_ops": st.device_ops() if st else [],
                     "idle_gaps": st.idle_gaps() if st else []}
    return SimpleNamespace(attempted=len(win_steps), failed=failed, numbers=numbers,
                           details=details, controls=control_numbers, e2e=e2e, layer=layer,
                           device=device, breakdown=breakdown)
