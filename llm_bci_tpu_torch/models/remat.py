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

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def remat_call(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args, generator)``, its activations recomputed in the backward."""
    if not torch.is_grad_enabled():
        return fn(*args, generator)
    if generator is None:
        # the global RNG: checkpoint's preserve_rng_state replays it
        return checkpoint(fn, *args, None, use_reentrant=False)
    state = generator.get_state()
    passes = []

    def run(*inner):
        if not passes:
            passes.append(1)
            return fn(*inner, generator)
        replay = torch.Generator(generator.device)
        replay.set_state(state)
        return fn(*inner, replay)

    return checkpoint(run, *args, use_reentrant=False)
