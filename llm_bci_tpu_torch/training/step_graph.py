"""One train step over static buffers, replayed as a CUDA graph on the card
(the port's counterpart of the JAX trainer's ``train_step_chained``: K steps
as one ``lax.scan`` program, ``llm_bci_tpu/training/trainer.py:663-685``).

``training.chain_steps: K > 1`` runs K train steps of one batch signature in
a row (``training/trainer.py``). On the card each of them replays one
captured step: eager, a step of the BCI fine-tune is some 10,000 kernel
launches, each enqueued by the host; replayed, it is the batch's copy into
the graph's input buffers, one graph launch, the outputs' copies and the
AdamW update's few multi-tensor launches. The graph holds the step's forward
and backward (and, at an update, the gradient clip); the update runs eagerly
after the replay, so that its learning rate and bias corrections are the
host floats of a single step (an AdamW with ``capturable=True`` reading its
learning rate from the device, inside the graph, took them in float32 and
moved the flagship's bf16 losses by up to 1.3e-4 over 8 steps against
``chain_steps: 1`` on an NVIDIA H100 80GB HBM3 at 700 W). One step is
captured and replayed K times, not K steps captured as one graph: the
graph's memory pool then holds one step's activations instead of K, a
signature is captured once whatever K is, and the kernels are those of the
eager step. :class:`TrainStepGraph` owns, at fixed addresses:

* ``slots``: the batch's tensors, which the trainer fills before each step
  (``Trainer.to_device(..., out=)`` from the host, or a gather from the
  device-resident batch pool, ``training/batch_cache.py``);
* ``outputs``: the step's outputs (``loss``, ``n_examples``, ``preds``, ...;
  a field the model leaves ``None`` stays ``None``), overwritten by every
  replay: the trainer copies them out before the lagged metric readback
  holds them;
* the parameters and their gradients, which the trainer keeps at fixed
  addresses for as long as it replays (the gradients are zeroed after an
  update, not freed; ``grads`` names the buffers a replay accumulates into,
  which the trainer attaches again before a replay should anything have
  replaced a parameter's gradient).

On CUDA the first step of a graph runs eagerly on a side stream and is the
real step; it records where each remat call of the step begins in the
training generator's stream (``models/remat.py``). The next step of that
signature is captured (``torch.cuda.graph``; a failed capture raises, there
is no eager retry), with the training generator and one generator for each
remat call registered with the graph, and replayed; every later step
replays. A replay draws what the eager step would draw from the generator's
state at that moment and moves it as far. Kernels launched inside the
capture count once in their wrappers' launch counters, when captured, so a
run reconciles its counts as ``models/decode_graph.py``'s do: launches a
step x (``EAGER_STEPS`` + ``CAPTURES``) on the host, x (``EAGER_STEPS`` +
``REPLAYS``) on the device. Under an NCCL process group the capture holds
the step's collectives too (FSDP2's all-gathers and reduce-scatters on their
own streams, joined back by its events; the ``tp`` / ``sp`` collectives; the
clip's all-reduces), captured in ``thread_local`` mode, so that another
thread's CUDA calls (a process group's watchdog queries its events) cannot
invalidate the capture. On a CPU tensor, and with
``capture=False`` (the trainer's choice for gloo ranks on the card, whose
collectives run on the host), the step function runs eagerly on the slots
every step.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from llm_bci_tpu_torch.models import remat

EAGER_STEPS = 0     # train steps run eagerly while chaining (first steps of a graph, single steps)
CAPTURES = 0        # graphs captured
REPLAYS = 0         # graph replays
CAPTURE_SECONDS = 0.0  # host seconds in capturing them


def reset_counters() -> None:
    global EAGER_STEPS, CAPTURES, REPLAYS, CAPTURE_SECONDS
    EAGER_STEPS = CAPTURES = REPLAYS = 0
    CAPTURE_SECONDS = 0.0


def count_eager_step() -> None:
    """A train step of a chaining run that ran eagerly outside a graph."""
    global EAGER_STEPS
    EAGER_STEPS += 1


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    # float64 columns reach the device as float32 (Trainer.to_device)
    return "float32" if np.dtype(dtype) == np.float64 else np.dtype(dtype).name


def batch_signature(batch: Dict[str, Any]) -> tuple:
    """Keys, shapes and dtypes (as on the device) of a batch's arrays or
    tensors: two batches of one signature fill one graph's slots."""
    return tuple(sorted((k, tuple(v.shape), _dtype_name(v.dtype)) for k, v in batch.items()
                        if isinstance(v, (np.ndarray, torch.Tensor))))


class TrainStepGraph:
    """The slots, outputs and graph of one train step (see the module
    docstring). ``step_fn(batch)`` runs a step on a batch dict and returns
    its outputs dict; ``generator`` is the training generator it draws from;
    ``capture=False`` runs every step eagerly on the slots, on the card too.
    Call :meth:`adopt` once with a first device batch, fill :attr:`slots`
    before each later step, and call the object for the step's outputs."""

    def __init__(self, step_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                 generator: Optional[torch.Generator], capture: bool = True):
        self.step_fn = step_fn
        self.generator = generator
        self.capture = capture
        self.slots: Optional[Dict[str, Any]] = None
        self.outputs: Optional[Dict[str, Any]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.remat_offsets: Optional[List[int]] = None
        self.remat_states: List[torch.Generator] = []
        self.grads: Optional[list] = None   # (parameter, gradient buffer) of the capture

    def adopt(self, batch: Dict[str, Any]) -> None:
        """Static copies of ``batch``'s tensors become the slots (its other
        entries stay as they are)."""
        self.slots = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in batch.items()}

    @property
    def device(self) -> torch.device:
        return next(v for v in self.slots.values() if torch.is_tensor(v)).device

    def _set_remat_states(self) -> None:
        if not self.remat_states:
            return
        state, offset = self.generator.get_state(), self.generator.get_offset()
        for gen, rel in zip(self.remat_states, self.remat_offsets):
            gen.set_state(state)
            gen.set_offset(offset + rel)

    def replay(self) -> Dict[str, Any]:
        global REPLAYS
        self._set_remat_states()
        self.graph.replay()
        REPLAYS += 1
        return self.outputs

    def __call__(self) -> Dict[str, Any]:
        global EAGER_STEPS, CAPTURES, CAPTURE_SECONDS
        if not self.capture or self.device.type != "cuda":
            EAGER_STEPS += 1
            return self.step_fn(self.slots)
        if self.graph is not None:
            return self.replay()
        if self.remat_offsets is None:
            # First step: eagerly on a side stream (as a capture's warm-up
            # must run), recording where its remat calls begin.
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if self.generator is not None and self.generator.device.type == "cuda":
                    with remat.recording(self.generator) as offsets:
                        out = self.step_fn(self.slots)
                else:
                    offsets, out = [], self.step_fn(self.slots)
            main.wait_stream(side)
            for v in out.values():
                if torch.is_tensor(v) and v.device.type == "cuda":
                    v.record_stream(main)
            self.remat_offsets = list(offsets)
            EAGER_STEPS += 1
            return out
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        self.remat_states = [torch.Generator(self.device) for _ in self.remat_offsets]
        for gen in self.remat_states:
            graph.register_generator_state(gen)
        # thread_local: another thread's CUDA calls (a process group's
        # watchdog queries its events) do not invalidate the capture
        with remat.capturing(self.remat_states), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.outputs = self.step_fn(self.slots)
        self.graph = graph
        CAPTURES += 1
        CAPTURE_SECONDS += time.perf_counter() - t0
        # the capture ran nothing: this step is the graph's first replay
        return self.replay()

    def free(self) -> None:
        """Drop the graph, its pool's tensors and the slots."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self.outputs, self.slots, self.remat_states = None, None, None, []
        self.grads = None
