"""Rematerialisation of one layer (the port's ``nn.remat``).

:func:`remat_call` runs ``fn(*args, generator)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
none of the layer's activations, and the backward runs the layer's forward
again to get them. Checkpointing saves and restores only torch's *default*
CPU and CUDA generators, but the port draws dropout masks, noise and the
flash kernels' dropout seeds from an explicit ``torch.Generator``. So the
generator's state is taken before the first pass, the recompute draws from a
copy of the generator set to that state, and the live generator is left where
the plain forward leaves it: the recompute sees the same masks and seeds, the
gradients belong to the forward that was run, and the stream of the next
layer and the next step is the one without remat (as ``nn.remat`` replays
the same keys in the JAX package).

Inside a CUDA graph capture of a train step (``training/step_graph.py``) a
generator's state cannot be read (its offset then lives on the device and
moves at every replay), and a generator that the graph does not know cannot
draw. There the step's graph hands in, through :func:`capturing`, one
generator registered with the graph for each remat call of the step, in the
order of the calls: the i-th call's recompute draws from the i-th. Before
each replay the graph sets each of them to the live generator's state
advanced by the offset at which that call began in the step, which the step's
first, eager run recorded (:func:`recording`); the replayed recompute then
draws the numbers of the replayed first pass. The default generators are
neither stashed nor restored in a capture (reading them is refused there):
a layer under an explicit generator draws nothing from them.

Non-reentrant checkpointing restores the autocast state at the recompute, so
the recomputed flash forward sees the dtype of the first pass, and it checks
that every recomputed saved tensor has the shape and dtype of the first. The
kernels' custom ops keep their tensors with ``save_for_backward`` in their
registered ``setup_context``, which the checkpoint's hooks see, after their
kernel has run: the recompute
launches every kernel of the layer whose saved tensors the backward needs.
Outside autograd (``torch.no_grad``, eval) the layer runs plainly.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

_RECORD: Optional[List[int]] = None        # offsets of the eager step's remat calls
_RECORD_GEN: Optional[torch.Generator] = None
_CAPTURE: Optional[Iterator[torch.Generator]] = None    # the capture's registered states


@contextlib.contextmanager
def recording(generator: torch.Generator):
    """Within the block, each remat call that draws from ``generator``
    appends to the yielded list its offset from ``generator``'s offset at
    the block's start (a CUDA generator's Philox offset)."""
    global _RECORD, _RECORD_GEN
    offsets: List[int] = []
    base = generator.get_offset()
    _RECORD, _RECORD_GEN = offsets, generator
    try:
        yield offsets
    finally:
        _RECORD, _RECORD_GEN = None, None
        offsets[:] = [o - base for o in offsets]


@contextlib.contextmanager
def capturing(states: List[torch.Generator]):
    """Within the block (a capture), the i-th remat call's recompute draws
    from ``states[i]``; a call beyond them raises."""
    global _CAPTURE
    _CAPTURE = iter(states)
    try:
        yield
    finally:
        _CAPTURE = None


def remat_call(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args, generator)``, its activations recomputed in the backward."""
    if not torch.is_grad_enabled():
        return fn(*args, generator)
    if generator is None:
        # the global RNG: checkpoint's preserve_rng_state replays it
        return checkpoint(fn, *args, None, use_reentrant=False)
    if _CAPTURE is not None:
        replay = next(_CAPTURE, None)
        if replay is None:
            raise RuntimeError("remat_call: more remat calls in the captured step than in its "
                               "eager run")
        preserve = False
    else:
        if _RECORD is not None and generator is _RECORD_GEN:
            _RECORD.append(generator.get_offset())
        replay = None
        preserve = True
        state = generator.get_state()
    passes = []

    def run(*inner):
        if not passes:
            passes.append(1)
            return fn(*inner, generator)
        if replay is None:
            fresh = torch.Generator(generator.device)
            fresh.set_state(state)
            return fn(*inner, fresh)
        return fn(*inner, replay)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=preserve)
