"""Co-smoothing evaluation: bits-per-spike of held-out neuron predictions
(counterpart of ``llm_bci_tpu/eval/co_smoothing.py``).

Modes:

* ``neuron``        — co-smooth mask one channel at a time;
* ``intra-region``  — all channels outside the target region masked, plus
  the held-out channel; targets restricted to the region;
* ``inter-region``  — mask all channels of one region, predict it from the
  others (one pass per region, scored per neuron).

The masked-channel / region selections are inputs of the model call
(:class:`~llm_bci_tpu_torch.models.masker.MaskerOverrides`), so one model
serves the whole sweep. The JAX package ``jax.vmap``s one eval over K stacked
override sets; the port folds the K sweep points into the batch instead: the
test batch is repeated K times, ``(K*B, T, N)``, and every override carries
one row for each of the K*B examples. (``torch.func.vmap`` cannot go through
the flash path's ``autograd.Function``, which launches its kernel through
ctypes.) Each point's prediction is sliced to its held-out channel on the
device before the copy to the host. Predictions run in eval mode, under
``torch.no_grad()`` and the trainer's autocast; the maskers draw from a
``torch.Generator`` seeded 0 on the trainer's device at each model call,
although every sweep masker is deterministic (selection ratios 0 or 1,
``zero_ratio`` 1).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_bci_tpu_torch.eval.metrics import bits_per_spike
from llm_bci_tpu_torch.models.masker import MaskerConfig, MaskerOverrides

SWEEP_BATCH = 8     # sweep points folded into one model call

_COSMOOTH = {
    "force_active": True, "mode": "co-smooth", "ratio": 1.0,
    "zero_ratio": 1.0, "random_ratio": 1.0, "channels": [0],
}
_INTRA_REGION = {
    "force_active": True, "mode": "intra-region", "ratio": 0.0,
    "zero_ratio": 1.0, "random_ratio": 1.0, "target_regions": [],
}
_INTER_REGION = {
    "force_active": True, "mode": "inter-region", "ratio": 1.0,
    "zero_ratio": 1.0, "random_ratio": 1.0, "mask_regions": [],
}
# The masker block of each mode's model.
SWEEP_MASKERS = {
    "neuron": {"main": _COSMOOTH},
    "intra-region": {"region": _INTRA_REGION, "main": _COSMOOTH},
    "inter-region": {"region": _INTER_REGION},
}


@contextlib.contextmanager
def maskers_swapped(model, masker_cfgs: Dict[str, dict]):
    """The model with its masker block replaced for the duration (NDT1's
    encoder; the port's maskers carry no parameters), restored after."""
    encoder = getattr(model, "encoder", None)
    if encoder is None or not hasattr(encoder, "masker_cfgs"):
        raise ValueError("Model carries no masker block")
    saved = encoder.masker_cfgs
    encoder.masker_cfgs = tuple(MaskerConfig.from_config(c) for c in masker_cfgs.values())
    try:
        yield model
    finally:
        encoder.masker_cfgs = saved


def _fold(ov: MaskerOverrides, B: int) -> MaskerOverrides:
    """Stacked ``(K, ...)`` selections of K sweep points as one row for each
    of the ``K*B`` examples of the folded batch (point k owns rows k*B ..)."""
    rows = lambda x: None if x is None else torch.repeat_interleave(x.reshape(x.shape[0], -1),
                                                                    B, dim=0)
    return MaskerOverrides(channels_onehot=rows(ov.channels_onehot),
                           mask_region_sel=rows(ov.mask_region_sel),
                           target_region_sel=rows(ov.target_region_sel))


def run_sweep(
    trainer,
    batches: Sequence[Dict[str, np.ndarray]],
    masker_cfgs: Dict[str, dict],
    overrides_for: Callable,
    points: Sequence,
    channel_for: Optional[Callable] = None,
    sweep_batch: int = SWEEP_BATCH,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yields ``(start, rates)`` chunks of up to ``sweep_batch`` sweep points.

    ``overrides_for(point) -> {masker index: MaskerOverrides}`` with
    single-point selections (``channels_onehot (N,)``, region selections
    ``(1, N)``). ``rates`` is ``(K, trials, T, N)``, or ``(K, trials, T)``
    with ``channel_for(point) -> int``: each point's prediction sliced to
    that channel on the device. Chunked so that the host never holds the
    whole ``(points, trials, T, N)`` array. Rates are ``exp`` of the
    predictions under a log-rate model."""
    model = trainer.model
    dev = trainer.device
    log_input = bool(getattr(model, "log_input", True))
    was_training = model.training
    model.eval()
    try:
        with maskers_swapped(model, masker_cfgs), torch.no_grad():
            for start in range(0, len(points), sweep_batch):
                chunk = list(points[start:start + sweep_batch])
                K = len(chunk)
                per_point = [overrides_for(pt) for pt in chunk]
                stacked = {
                    i: MaskerOverrides(**{
                        f: (torch.stack([getattr(ovs[i], f) for ovs in per_point]).to(dev)
                            if getattr(per_point[0][i], f) is not None else None)
                        for f in ("channels_onehot", "mask_region_sel", "target_region_sel")
                    })
                    for i in per_point[0]
                }
                chs = (torch.as_tensor([channel_for(pt) for pt in chunk], device=dev)
                       if channel_for else None)
                parts = []
                for batch in batches:
                    # every model call draws from a generator seeded 0, as the
                    # JAX package passes PRNGKey(0) to each (deterministic
                    # either way: the sweep maskers' draws are 0 or 1)
                    generator = torch.Generator(dev).manual_seed(0)
                    inputs = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                    B = inputs["spikes"].shape[0]
                    folded = {k: v.repeat(K, *([1] * (v.dim() - 1))) for k, v in inputs.items()}
                    with trainer.autocast():
                        preds = model(**folded, generator=generator,
                                      masker_overrides={i: _fold(ov, B)
                                                        for i, ov in stacked.items()}).preds
                    preds = preds.reshape(K, B, *preds.shape[1:])
                    if chs is not None:
                        preds = preds[torch.arange(K, device=dev), :, :, chs]   # (K, B, T)
                    parts.append(preds.float().cpu().numpy())
                rates = np.concatenate(parts, axis=1)
                yield start, (np.exp(rates) if log_input else rates)
    finally:
        model.train(was_training)


def sweep_inputs(trainer) -> Tuple[List[Dict[str, np.ndarray]], List[str]]:
    """The trainer's test batches as the sweep takes them (the numpy model
    inputs, each with ``neuron_regions_idx``: the id of each channel's region
    among the sorted region names) and the region of each channel."""
    region_list = [str(r) for r in trainer.test_dataset[0]["neuron_regions"]]
    region_to_id = {r: i for i, r in enumerate(sorted(set(region_list)))}
    row = np.asarray([region_to_id[r] for r in region_list], np.int32)
    batches = []
    for model_inputs, _ in trainer.test_dataloader:
        batch = {k: v for k, v in model_inputs.items() if isinstance(v, np.ndarray)}
        if "neuron_regions_idx" not in batch:
            batch["neuron_regions_idx"] = np.tile(row, (batch["spikes"].shape[0], 1))
        batches.append(batch)
    return batches, region_list


def mode_overrides(mode: str, region_list: Sequence[str]) -> Callable:
    """``overrides_for(point)`` of a mode's sweep: the point is a held-out
    channel (``neuron``; ``intra-region`` also targets its region) or a
    region name (``inter-region``: the region is masked)."""
    regions = sorted(set(region_list))
    ids = np.asarray([regions.index(r) for r in region_list])
    onehot = lambda n_i: torch.from_numpy(np.arange(len(region_list)) == n_i)
    sel = lambda region: torch.from_numpy((ids == regions.index(region))[None, :])
    if mode == "neuron":
        return lambda n_i: {0: MaskerOverrides(channels_onehot=onehot(n_i))}
    if mode == "intra-region":
        return lambda n_i: {0: MaskerOverrides(target_region_sel=sel(region_list[n_i])),
                            1: MaskerOverrides(channels_onehot=onehot(n_i))}
    if mode == "inter-region":
        return lambda region: {0: MaskerOverrides(mask_region_sel=sel(region))}
    raise ValueError(f"Unknown co-smoothing mode {mode!r}")


def co_smoothing_eval(
    trainer,
    save_path: str = "figs",
    method: str = "",
    is_aligned: bool = False,
    subtract_psth: Optional[str] = "task",
    onset_alignment: Optional[List[int]] = None,
    target_regions: Optional[List[str]] = None,
    modes: Optional[List[str]] = None,
    make_r2_plots: bool = False,
    max_N: Optional[int] = None,
) -> Dict[str, Dict[str, list]]:
    """Bits-per-spike (and, with ``make_r2_plots``, PSTH / single-trial R2 with
    their figures under ``save_path``) of every held-out neuron of the
    trainer's test set, per mode: ``{mode: {"bps": [...], "r2": [...]}}``."""
    modes = modes or ["neuron", "intra-region", "inter-region"]
    target_regions = target_regions or ["all"]
    onset_alignment = onset_alignment if onset_alignment is not None else [40]

    batches, region_list = sweep_inputs(trainer)
    uuids_list = trainer.test_dataset[0].get(
        "neuron_uuids", [str(i) for i in range(len(region_list))]
    )
    all_regions = sorted(set(region_list))
    neurons_by_region = {
        r: [i for i, rr in enumerate(region_list) if rr == r] for r in all_regions
    }
    if "all" in target_regions:
        target_regions = all_regions
    N = max_N or batches[0]["spikes"].shape[2]
    T = batches[0]["spikes"].shape[1]

    # Condition matrix for aligned sessions: choice / reward / block tiled
    # over time.
    behavior_set = None
    var_name2idx = var_value2label = var_tasklist = None
    if is_aligned:
        rows = [trainer.test_dataset[i] for i in range(len(trainer.test_dataset))]
        b_list = []
        for var in ("choice", "reward", "block"):
            v = np.stack([np.asarray(r[var]).reshape(-1)[0] for r in rows], axis=0)
            b_list.append(np.tile(v[:, None], (1, T)))
        behavior_set = np.stack(b_list, axis=-1)
        var_name2idx = {"choice": [0], "reward": [1], "block": [2], "wheel": [3]}
        var_value2label = {
            "block": {(0.2,): "p(left)=0.2", (0.5,): "p(left)=0.5", (0.8,): "p(left)=0.8"},
            "choice": {(-1.0,): "right", (1.0,): "left"},
            "reward": {(0.0,): "no reward", (1.0,): "reward"},
        }
        var_tasklist = ["block", "choice", "reward"]

    spikes_all = np.concatenate([b["spikes"] for b in batches], axis=0)

    def score(rates: np.ndarray, n_i: int, mode: str):
        # rates: (trials, T, N) from a full-prediction pass, or (trials, T)
        # already sliced to channel n_i on the device.
        col = rates if rates.ndim == 2 else rates[:, :, n_i]
        bps = bits_per_spike(col[:, :, None], spikes_all[:, :, [n_i]])
        r2 = [0.0, 0.0]
        if make_r2_plots:
            if is_aligned:
                from llm_bci_tpu_torch.eval.viz_neuron_fit import viz_single_cell

                r2 = list(
                    viz_single_cell(
                        behavior_set, spikes_all[:, :, n_i], col,
                        var_name2idx, var_tasklist, var_value2label, [],
                        subtract_psth=subtract_psth,
                        aligned_tbins=onset_alignment,
                        neuron_idx=str(uuids_list[n_i])[:4],
                        neuron_region=region_list[n_i],
                        method=method, mode=mode, save_path=save_path,
                    )
                )
            else:
                from llm_bci_tpu_torch.eval.viz_neuron_fit import viz_single_cell_unaligned

                r2 = [
                    viz_single_cell_unaligned(
                        spikes_all[:, :, n_i], col,
                        neuron_idx=str(uuids_list[n_i])[:4],
                        neuron_region=region_list[n_i],
                        method=method, mode=mode, save_path=save_path,
                    ),
                    0.0,
                ]
        return bps, r2

    results: Dict[str, Dict[str, list]] = {}
    for mode in ("neuron", "intra-region"):
        if mode not in modes:
            continue
        bps_list, r2_list = [], []
        for start, rates in run_sweep(trainer, batches, SWEEP_MASKERS[mode],
                                      mode_overrides(mode, region_list), list(range(N)),
                                      channel_for=lambda n_i: n_i):
            for j in range(rates.shape[0]):
                bps, r2 = score(rates[j], start + j, mode)
                bps_list.append(bps)
                r2_list.append(r2)
        results[mode] = {"bps": bps_list, "r2": r2_list}

    if "inter-region" in modes:
        bps_list, r2_list = [], []
        for region in target_regions:
            ((_, rates),) = run_sweep(
                trainer, batches, SWEEP_MASKERS["inter-region"],
                mode_overrides("inter-region", region_list), [region], sweep_batch=1)
            for n_i in neurons_by_region[region]:
                if n_i >= N:
                    continue
                bps, r2 = score(rates[0], n_i, "inter-region")
                bps_list.append(bps)
                r2_list.append(r2)
        results["inter-region"] = {"bps": bps_list, "r2": r2_list}

    return results
