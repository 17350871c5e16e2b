"""One token step of a decode over static buffers, replayed as a CUDA graph
on the card (the port's counterpart of the JAX package's jitted ``lax.scan``
body, ``llm_bci_tpu/models/generation.py``).

A token step is ``decode_step(embeds (N, 1, H), key_mask (N, S), cache,
position) -> (logits (N, 1, V), cache)`` with ``position`` a 0-dim int64
tensor (``LlamaForCausalLM.forward``'s tensor ``cache_index``). Eager, one
step of a 32-layer Llama is some 3,500 kernel launches, each enqueued by the
host; captured once, a step is one graph launch. :class:`TokenStep` owns the
buffers the graph reads and writes, at fixed addresses:

* ``embeds`` (N, 1, H): the chosen tokens' embeddings, copied in each step;
* ``key_mask`` (N, S): the key mask of the cache, which the caller updates in
  place (a new slot, a beam reorder);
* ``position``: the cache slot the step writes, a 0-dim tensor set each step;
* ``cache``: the KV cache of ``init_cache``, written in place by the prefill
  and by every step (a beam reorder copies into it);
* ``logits`` (N, V): the step's last-position logits, valid until the next
  step.

On CUDA the first step runs eagerly on a side stream and is the real first
token step, at the first free slot: its KV write is the one the step makes
anyway (a warm-up at a slot the prompt fills would overwrite the prompt's
keys). The step is then captured (``torch.cuda.graph``; a failed capture
raises, there is no eager retry) and every later step replays the graph.
A :class:`TokenStep` serves one decode: each decode captures its own graph
from the code and tensors of that moment, so nothing outlives the decode
that a later change of either could leave stale. Kernels launched inside the capture count once in their wrappers' launch
counters, when captured; ``REPLAYS`` counts the replays, so that a run can
reconcile its counts: launches a step x (eager steps + captures) on the
host, x (eager steps + replays) on the device. On a CPU tensor (the tests)
the step function is called directly every step.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

EAGER_STEPS = 0     # steps run eagerly (the first step of each decode on the card, every CPU step)
CAPTURES = 0        # graphs captured
REPLAYS = 0         # graph replays
CAPTURE_SECONDS = 0.0  # host seconds in capturing them (the first steps' eager runs apart)


def reset_counters() -> None:
    global EAGER_STEPS, CAPTURES, REPLAYS, CAPTURE_SECONDS
    EAGER_STEPS = CAPTURES = REPLAYS = 0
    CAPTURE_SECONDS = 0.0


class TokenStep:
    """The static buffers of one decode and its token step (see the module
    docstring). ``step(embeds, position)`` runs a step and returns the
    ``(N, V)`` logits buffer."""

    def __init__(self, decode_step: Callable, cache, key_mask: torch.Tensor):
        self.decode_step = decode_step
        self.cache = cache
        self.key_mask = key_mask
        self.embeds: Optional[torch.Tensor] = None
        self.position = torch.zeros((), dtype=torch.long, device=key_mask.device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def run_eager(self) -> torch.Tensor:
        """The un-graphed step on the static buffers, as it is captured."""
        logits, _ = self.decode_step(self.embeds, self.key_mask, self.cache, self.position)
        return logits[:, -1, :]

    def __call__(self, embeds: torch.Tensor, position: int) -> torch.Tensor:
        global EAGER_STEPS, CAPTURES, REPLAYS, CAPTURE_SECONDS
        if self.embeds is None:
            self.embeds = torch.empty_like(embeds)
        self.embeds.copy_(embeds)
        self.position.fill_(position)
        if self.key_mask.device.type != "cuda":
            EAGER_STEPS += 1
            return self.run_eager()
        if self.graph is not None:
            self.graph.replay()
            REPLAYS += 1
            return self.logits
        # First step: eagerly on a side stream (as a capture's warm-up must
        # run), then capture the same step.
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = self.run_eager()
        main.wait_stream(side)
        first.record_stream(main)
        EAGER_STEPS += 1
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = self.run_eager()
        self.graph = graph
        CAPTURES += 1
        CAPTURE_SECONDS += time.perf_counter() - t0
        return first

