"""Entry point of the port for a quick check that it runs (counterpart of
``entry()`` in the repo's ``__graft_entry__.py``).

``entry(device=None)`` returns ``(fn, (model, batch))``: ``fn(model, batch)``
is the NDT1-CTC forward loss in eval mode, without a gradient, on the
flagship recipe cut to 2 layers x 64 hidden (stacking 8 / 4) and a batch of
B=4 trials, T=128 bins, N=64 channels, S=16 labels from a vocabulary of 41.
The weights are torch's initialisation under seed 0, made on the CPU, so that
every device gets the same model. On the card the loss runs the CTC forward
kernel (``ctc_alpha_kernel``); ``device="cpu"`` runs its plain version.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from llm_bci_tpu_torch.config import resolve_path, update_config
from llm_bci_tpu_torch.models.ndt1 import NDT1
from llm_bci_tpu_torch.training.trainer import resolve_device


def _ndt1_ctc_model(n_channels=64, max_F=128, hidden=64, n_layers=2, vocab=41,
                    stack_size=8, stack_stride=4) -> NDT1:
    cfg = update_config(resolve_path("configs/ndt1.yaml"), {
        "encoder": {
            "masker": {"neuron": {"active": False}},
            "embedder": {
                "n_channels": n_channels, "max_F": max_F, "input_dim": n_channels,
                "stack": {"active": True, "size": stack_size, "stride": stack_stride},
            },
            "transformer": {"n_layers": n_layers, "hidden_size": hidden, "n_heads": 4,
                            "inter_size": hidden},
        },
    })
    return NDT1.from_config(cfg, method_name="ctc", vocab_size=vocab, blank_id=0,
                            zero_infinity=True)


def _ndt1_batch(B=4, T=128, N=64, S=16, vocab=41, seed=0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "spikes": rng.poisson(1.0, size=(B, T, N)).astype(np.float32),
        "spikes_mask": np.ones((B, T), np.int32),
        "spikes_timestamp": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
        "spikes_lengths": np.full((B,), T, np.int32),
        "targets": rng.integers(1, vocab, size=(B, S)).astype(np.int32),
        "targets_lengths": rng.integers(2, S, size=(B,)).astype(np.int32),
    }


def entry(device=None) -> Tuple[Callable, Tuple[NDT1, Dict[str, torch.Tensor]]]:
    """``(fn, (model, batch))``: the NDT1-CTC forward loss, its model and
    batch on ``device`` (default CUDA; without a card that raises)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = _ndt1_ctc_model()
    model = model.to(device).eval()
    batch = {k: torch.from_numpy(v).to(device) for k, v in _ndt1_batch().items()}

    def fn(model: NDT1, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return model(**batch).loss

    return fn, (model, batch)
