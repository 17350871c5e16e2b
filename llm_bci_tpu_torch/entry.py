"""Entry points of the port for a quick check that it runs (counterparts of
``entry()`` and ``dryrun_multichip()`` in the repo's ``__graft_entry__.py``).

``entry(device=None)`` returns ``(fn, (model, batch))``: ``fn(model, batch)``
is the NDT1-CTC forward loss in eval mode, without a gradient, on the
flagship recipe cut to 2 layers x 64 hidden (stacking 8 / 4) and a batch of
B=4 trials, T=128 bins, N=64 channels, S=16 labels from a vocabulary of 41.
The weights are torch's initialisation under seed 0, made on the CPU, so that
every device gets the same model. On the card the loss runs the CTC forward
kernel (``ctc_alpha_kernel``); ``device="cpu"`` runs its plain version.

``dryrun_multichip(n, device=None)`` starts ``n`` ranks
(``parallel/process.py::spawn``), one a card with NCCL (``cuda:LOCAL_RANK``;
it raises when the host has fewer than ``n`` cards), or ``n`` gloo ranks on
the CPU when the caller passes ``device="cpu"``, and runs one training step
through the port's ``Trainer`` on tiny shapes in each of two meshes: NDT1 ``mlm`` (random
masker, dropout) on ``(data, fsdp, sp)`` with the JAX dry run's axes
(``fsdp = 2`` when ``n`` is even, ``sp = 2`` when ``2 * fsdp`` divides ``n``
at least twice, ``data`` the rest: ``sp = 2`` from 8 ranks); and the debug
BCI (int8 base, LoRA on q / v) on ``(data, fsdp, tp)``, ``tp = 2`` when
``n`` is even and ``fsdp = 2`` when 4 divides ``n``. Run it as
``python -m llm_bci_tpu_torch.entry --dryrun N [--device cpu]``.
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from llm_bci_tpu_torch.config import DictConfig, resolve_path, update_config
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


# ------------------------------------------------------------ multi-device

def _pad() -> dict:
    return {"dim": 0, "side": "right", "value": 0, "truncate": None, "min_length": None}


def _ndt1_mlm_config(tmp: str, batch: int, parallelism: dict) -> DictConfig:
    T, N = 16, 8
    return DictConfig({
        "savestring": "dryrun", "verbosity": 3,
        "dirs": {"checkpoint_dir": tmp, "log_dir": None},
        "training": {"num_epochs": 1, "train_batch_size": batch, "test_batch_size": batch,
                     "max_steps": 1, "drop_last_train_dataloader": True,
                     "save_on_preemption": False},
        "model": {"model_class": "NDT1", "encoder": {
            "masker": {"neuron": {"active": True, "mode": "random", "ratio": 0.3}},
            "embedder": {"n_channels": N, "max_F": T, "input_dim": 8,
                         "stack": {"active": False}},
            "transformer": {"n_layers": 2, "hidden_size": 16, "n_heads": 2, "inter_size": 16},
        }},
        "data": {"dataset_class": "base"},
        "method": {
            "model_kwargs": {"method_name": "mlm", "loss": "poisson_nll", "log_input": True},
            "dataloader_kwargs": {"pad_dict": {k: _pad() for k in
                                               ("spikes", "spikes_mask", "spikes_timestamp")}},
            "metric_kwargs": {},
        },
        "optimizer": {"lr": 1e-3, "scheduler": "cosine"},
        "precision": {"compute_dtype": "float32"},
        "parallelism": {**parallelism, "fsdp_min_size": 64},
    })


def _bci_config(tmp: str, batch: int, parallelism: dict) -> DictConfig:
    """The debug-Llama BCI of the JAX dry run (int8 base, LoRA r=2 on q / v)."""
    pad_keys = ("spikes", "spikes_mask", "spikes_timestamp", "input_ids", "attention_mask",
                "targets_mask")
    return DictConfig({
        "savestring": "dryrun_bci", "verbosity": 3,
        "dirs": {"checkpoint_dir": tmp, "log_dir": None},
        "training": {"num_epochs": 1, "train_batch_size": batch, "test_batch_size": batch,
                     "max_steps": 1, "drop_last_train_dataloader": True,
                     "save_on_preemption": False},
        "model": {
            "model_class": "BCI",
            "ndt1": {"encoder": {
                "masker": {"neuron": {"active": False}},
                "smooth_and_noise": {"smooth_sd": 1, "white_noise_sd": 0.1,
                                     "constant_offset_sd": None},
                "embedder": {"n_channels": 8, "max_F": 16, "input_dim": 12,
                             "stack": {"active": True, "size": 4, "stride": 2},
                             "dropout": 0.1},
                "transformer": {"n_layers": 2, "hidden_size": 16, "n_heads": 2,
                                "inter_size": 32, "dropout": 0.1},
            }},
            "projector": {"stacking": 2, "inter_size": 24, "bias": True, "act": "relu"},
        },
        "data": {"dataset_class": "decoding"},
        "method": {
            "model_kwargs": {
                "method_name": "endtoend", "debug": True, "quantize": "int8",
                "lora": {"r": 2, "alpha": 16, "dropout": 0.0,
                         "target_modules": ["q_proj", "v_proj"], "modules_to_save": []},
                "freeze_llm": False,
            },
            "dataset_kwargs": {"targets_name": "labels"},
            "dataloader_kwargs": {"pad_dict": {**{k: _pad() for k in pad_keys},
                                               "targets": {**_pad(), "value": -100}}},
            "metric_kwargs": {},
        },
        "optimizer": {"lr": 1e-3, "scheduler": "cosine", "warmup_pct": 0.3},
        "precision": {"compute_dtype": "float32"},
        "parallelism": {**parallelism, "fsdp_min_size": 64},
    })


def _spike_rows(n: int, T: int = 16, N: int = 8, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"spikes": rng.poisson(1.0, size=(T, N)).astype(np.float32)} for _ in range(n)]


def _bci_rows(n: int, T: int = 16, N: int = 8, L: int = 10, vocab: int = 97,
              seed: int = 0) -> list:
    """Tiny pre-tokenized BCI trials (the JAX dry run's ``_synth_bci_dataset``)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        sent_len = int(rng.integers(2, 5))
        input_ids = rng.integers(3, vocab, size=(L,)).astype(np.int64)
        labels = np.concatenate([np.full(L - sent_len, -100, np.int64),
                                 input_ids[L - sent_len:]])
        rows.append({"spikes": rng.poisson(1.0, size=(T, N)).astype(np.float32),
                     "input_ids": input_ids, "attention_mask": np.ones(L, np.int64),
                     "input_split": np.atleast_1d(3), "labels": labels,
                     "sentence": "a b c", "day_idx": np.asarray(i % 2),
                     "block_idx": np.asarray(i % 2)})
    return rows


def dryrun_meshes(n: int) -> Tuple[dict, dict]:
    """The ``(data, fsdp, sp)`` mesh of the NDT1 leg (the axes of
    ``__graft_entry__.dryrun_multichip``) and the ``(data, fsdp, tp)`` mesh
    of the BCI leg for ``n`` ranks."""
    fsdp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (2 * fsdp) == 0 and n // (2 * fsdp) >= 2 else 1
    tp = 2 if n % 2 == 0 else 1
    fsdp_bci = 2 if n % 4 == 0 else 1
    return ({"data": n // (fsdp * sp), "fsdp": fsdp, "sp": sp},
            {"data": n // (fsdp_bci * tp), "fsdp": fsdp_bci, "tp": tp})


def dryrun_steps(tmp: str, device) -> str:
    """The dry run's two training steps on this rank of an initialized
    process group (every rank calls it), on this rank's ``device``; returns
    its report line."""
    import torch.distributed as dist

    from llm_bci_tpu_torch.training.trainer import Trainer

    n = dist.get_world_size()
    ndt1_mesh, bci_mesh = dryrun_meshes(n)
    batch = 2 * ndt1_mesh["data"]
    trainer = Trainer(_ndt1_mlm_config(tmp, batch, ndt1_mesh),
                      dataset={"train": _spike_rows(2 * batch), "test": _spike_rows(batch, seed=1)},
                      device=device)
    trainer.train()
    batch = 2 * bci_mesh["data"]
    trainer = Trainer(_bci_config(tmp, batch, bci_mesh),
                      dataset={"train": _bci_rows(2 * batch), "test": _bci_rows(batch, seed=1)},
                      device=device)
    trainer.train()
    return (f"dryrun_multichip({n}) OK: NDT1 mesh={ndt1_mesh}, BCI mesh={bci_mesh}, "
            "one step each")


def _dryrun_rank(tmp: str, device: str) -> None:
    """One rank of :func:`dryrun_multichip`: ``device`` is ``cpu`` (gloo) or
    ``cuda`` (NCCL on ``cuda:LOCAL_RANK``)."""
    import torch.distributed as dist

    from llm_bci_tpu_torch.parallel import process

    rank_device = process.init_process("cpu" if device == "cpu" else None, timeout_s=120.0)
    report = dryrun_steps(tmp, rank_device)
    if dist.get_rank() == 0:
        print(report, flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n: int = 2, device=None) -> str:
    """One training step of NDT1 ``mlm`` and of the debug BCI on ``n`` ranks
    (see the module's docstring): one card a rank unless ``device="cpu"``.
    Raises when the host has fewer cards than ranks, or when a rank fails.
    Returns rank 0's output."""
    device = "cuda" if device is None else str(torch.device(device).type)
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n:
            raise RuntimeError(f"dryrun_multichip({n}) runs one rank a card and this host has "
                               f"{cards}; pass device='cpu' for {n} gloo ranks on the CPU")
    elif device != "cpu":
        raise ValueError(f"dryrun_multichip: device must be 'cuda' or 'cpu', not {device!r}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from llm_bci_tpu_torch.parallel import process

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        # one thread a rank: the n ranks share this host's cores
        runs = process.spawn(["-m", "llm_bci_tpu_torch.entry", "--dryrun-rank", tmp, device],
                             n, env={"OMP_NUM_THREADS": "1"}, cwd=root, timeout_s=300.0)
    return runs[0].stdout


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-rank"]:
        _dryrun_rank(sys.argv[2], sys.argv[3])
    else:
        import argparse

        cli = argparse.ArgumentParser(prog="python -m llm_bci_tpu_torch.entry")
        cli.add_argument("--dryrun", type=int, required=True, metavar="N",
                         help="ranks of the dry run")
        cli.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                         help="one card a rank (NCCL), or gloo ranks on the CPU")
        args = cli.parse_args()
        print(dryrun_multichip(args.dryrun, device=args.device), end="")
