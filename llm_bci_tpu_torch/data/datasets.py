# Mirrors llm_bci_tpu/data/datasets.py (host code that imports no JAX): the port keeps its own copy.
"""Example-dict datasets + static-shape pad/collate.

Host-side numpy data pipeline. Mirrors the reference dataset family
(``data_utils/datasets.py:23-175``) and its pad/collate protocol
(``data_utils/datasets.py:191-271``), with one deliberate deviation for TPU:
the trainer always fixes ``truncate == min_length`` per padded key so every
batch has identical shapes — XLA compiles the train step once. The reference
pads to the per-batch max, which would trigger a recompile per unique shape.

No torch: collated batches are numpy arrays which the trainer transfers to
device with the proper :class:`jax.sharding.NamedSharding`.
"""
from __future__ import annotations

import math
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from llm_bci_tpu_torch.registry import register_dataset


def _example_features(spikes: np.ndarray) -> Dict[str, np.ndarray]:
    """Derived per-example columns shared by all dataset classes
    (reference ``data_utils/datasets.py:42-49``)."""
    seq_len, n_channels = spikes.shape
    return {
        "spikes": spikes,                                         # (seq_len, n_channels)
        "spikes_mask": np.ones(seq_len, dtype=np.int64),          # (seq_len,)
        "spikes_timestamp": np.arange(seq_len, dtype=np.int64),   # (seq_len,)
        "spikes_spacestamp": np.arange(n_channels, dtype=np.int64),  # (n_channels,)
        "spikes_lengths": np.asarray(seq_len, dtype=np.int64),    # scalar
    }


@register_dataset("base")
class SpikingDataset:
    """Map-style dataset over a list of example dicts; adds the derived
    spike columns (reference ``data_utils/datasets.py:23-50``)."""

    def __init__(
        self,
        dataset: List[Dict[str, Any]],
        length: Optional[int] = None,
        spikes_name: str = "spikes",
        **kwargs,
    ):
        self.dataset = dataset[:length] if length is not None else dataset
        self.spikes_name = spikes_name

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        inputs = deepcopy(self.dataset[idx])
        spikes = np.asarray(inputs.pop(self.spikes_name))
        inputs.update(_example_features(spikes))
        return inputs


@register_dataset("decoding")
class SpikingDatasetForDecoding(SpikingDataset):
    """Adds ``targets``/``targets_mask``/``targets_lengths`` from a
    configurable column (reference ``data_utils/datasets.py:66-97``)."""

    def __init__(
        self,
        dataset: List[Dict[str, Any]],
        length: Optional[int] = None,
        spikes_name: str = "spikes",
        targets_name: str = "targets",
        **kwargs,
    ):
        super().__init__(dataset, length, spikes_name)
        self.targets_name = targets_name

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        inputs = deepcopy(self.dataset[idx])
        spikes = np.asarray(inputs.pop(self.spikes_name))
        targets = np.asarray(inputs.pop(self.targets_name))
        inputs.update(_example_features(spikes))
        inputs.update(
            {
                "targets": targets,
                "targets_mask": np.ones_like(targets),
                "targets_lengths": np.asarray(targets.shape[0], dtype=np.int64),
            }
        )
        return inputs


@register_dataset("day")
class DaySpecificSpikingDatasetForDecoding(SpikingDataset):
    """Each ``__getitem__`` yields a day-homogeneous mini-batch (a list of
    examples) — pairs with NDT1 per-day ``adapt`` embeddings (reference
    ``data_utils/datasets.py:115-175``).

    Day-batch composition is STATELESS: the reference draws from shuffled
    per-day index pools mutated inside ``__getitem__`` (pop-until-empty,
    refill+reshuffle), which makes a resumed run re-draw different batches
    than the uninterrupted one. Because every batch index is visited
    exactly once per epoch, one reference epoch consumes each day's pool
    exactly (``ceil(n_d/bs)`` visits x ``min(bs, remaining)`` pops == n_d),
    so pool state at epoch boundaries is just the reshuffle RNG — the whole
    scheme is equivalent to drawing day ``d``'s epoch-``e`` order from a
    pure function of ``(seed, e, d)``. We implement exactly that: batch
    ``k`` of day ``d`` (its position among the day's batch indices, not
    visit order) takes slice ``[k*bs:(k+1)*bs]`` of
    ``default_rng((seed, epoch, day)).permutation(n_d)``. The trainer's
    dataloader pins the epoch via :meth:`set_epoch`, so mid-epoch
    fast-forward reproduces the interrupted run's day-batch composition
    byte-for-byte (the strong deterministic-resume guarantee now covers
    the ``day`` dataset class too)."""

    def __init__(
        self,
        dataset: List[Dict[str, Any]],
        batch_size: int,
        length: Optional[int] = None,
        spikes_name: str = "spikes",
        targets_name: str = "targets",
        seed: int = 0,
        **kwargs,
    ):
        super().__init__(dataset, length, spikes_name)
        self.batch_size = batch_size
        self.targets_name = targets_name
        self.seed = int(seed)
        self._epoch = 0
        self._order_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self.day_idxs = sorted(set(int(row["day_idx"]) for row in self.dataset))
        self.day_datasets = {
            d: [row for row in self.dataset if int(row["day_idx"]) == d] for d in self.day_idxs
        }

    def __len__(self) -> int:
        return sum(math.ceil(len(rows) / self.batch_size) for rows in self.day_datasets.values())

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch whose per-day orders ``__getitem__`` samples from
        (forwarded by ``HostDataLoader.__iter__``)."""
        self._epoch = int(epoch)

    def _day_order(self, day: int) -> np.ndarray:
        key = (self._epoch, day)
        order = self._order_cache.get(key)
        if order is None:
            # one entry per day is enough — epochs advance monotonically
            self._order_cache = {
                k: v for k, v in self._order_cache.items() if k[0] == self._epoch
            }
            order = np.random.default_rng(
                (self.seed, self._epoch, day)
            ).permutation(len(self.day_datasets[day]))
            self._order_cache[key] = order
        return order

    def _day_for_batch(self, idx: int) -> Tuple[int, int]:
        """(day, within-day batch number) for global batch index ``idx``."""
        cum = 0
        for d in self.day_idxs:
            n_batches = math.ceil(len(self.day_datasets[d]) / self.batch_size)
            if idx < cum + n_batches:
                return d, idx - cum
            cum += n_batches
        raise IndexError(idx)

    def __getitem__(self, idx: int) -> List[Dict[str, Any]]:
        day, k = self._day_for_batch(idx)
        order = self._day_order(day)
        batch_idx = order[k * self.batch_size : (k + 1) * self.batch_size]

        out = []
        for j in batch_idx:
            inputs = deepcopy(self.day_datasets[day][j])
            spikes = np.asarray(inputs.pop(self.spikes_name))
            targets = np.asarray(inputs.pop(self.targets_name))
            inputs.update(_example_features(spikes))
            inputs.update(
                {
                    "targets": targets,
                    "targets_mask": np.ones_like(targets),
                    "targets_lengths": np.asarray(targets.shape[0], dtype=np.int64),
                }
            )
            out.append(inputs)
        return out


def padded_array(
    arrays: List[np.ndarray],
    dim: int = 0,
    side: str = "right",
    value: Union[int, float] = 0,
    truncate: Optional[int] = None,
    min_length: Optional[int] = None,
) -> np.ndarray:
    """Stack arrays that differ only along ``dim``, padding on ``side`` with
    ``value``; clamp to ``truncate`` and pad at least to ``min_length``
    (reference ``data_utils/datasets.py:191-221``). Returns a batched array
    with a prepended batch dimension."""
    if side not in ("left", "right"):
        raise ValueError(f'"side" can only be "left" or "right", got {side!r}')
    max_size = max(arr.shape[dim] for arr in arrays)
    truncate = max_size if truncate is None else truncate
    min_length = 0 if min_length is None else min_length
    if min_length > truncate:
        raise ValueError("Can't truncate below the minimum length")
    pad_size = min(truncate, max(max_size, min_length))

    ndim = arrays[0].ndim
    out = []
    for arr in arrays:
        pad_width = [(0, 0)] * ndim
        grow = max(0, pad_size - arr.shape[dim])
        pad_width[dim] = (grow, 0) if side == "left" else (0, grow)
        padded = np.pad(arr, pad_width, mode="constant", constant_values=value)
        slc = [slice(None)] * ndim
        # Deviation from the reference (which always keeps slice(0, truncate),
        # data_utils/datasets.py:219): with side="left" the pad sits at the
        # START, so truncation must keep the TAIL — otherwise truncated rows
        # end-align differently from padded rows in the same batch. Latent in
        # practice: freeze_pad_lengths pins truncate to the dataset max, so
        # nothing is actually cut unless a config sets truncate explicitly.
        slc[dim] = (
            slice(padded.shape[dim] - truncate, None)
            if side == "left" and padded.shape[dim] > truncate
            else slice(0, truncate)
        )
        out.append(padded[tuple(slc)])
    return np.stack(out, axis=0)


def pad_collate_fn(
    batch: List[Dict[str, Any]],
    model_inputs: List[str],
    pad_dict: Dict[str, Dict[str, Any]],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Collate a list of example dicts into ``(model_inputs, unused_inputs)``.

    Numeric array columns in ``pad_dict`` are padded/stacked; equal-shape
    array columns are stacked as-is; ragged non-padded arrays stay a list;
    non-array columns (e.g. ``sentence`` strings) stay a list. Columns named
    in ``model_inputs`` go to the first dict, everything else to the second
    (reference ``data_utils/datasets.py:236-271``).
    """
    # Dataset-side batching (day-specific dataset) yields lists of examples.
    if batch and isinstance(batch[0], list):
        batch = [row for sub in batch for row in sub]

    keys = list(batch[0].keys())
    array_keys = {
        k
        for k in keys
        if isinstance(batch[0][k], np.ndarray) and batch[0][k].dtype.type != np.str_
    }
    string_array_keys = {
        k
        for k in keys
        if isinstance(batch[0][k], np.ndarray) and batch[0][k].dtype.type == np.str_
    }
    missing = set(pad_dict) - array_keys
    if missing & set(keys):
        raise ValueError(f"Can't pad keys which are not arrays: {missing & set(keys)}")

    collated: Dict[str, Any] = {}
    unused: Dict[str, Any] = {}
    for key in keys:
        if key in array_keys:
            if key in pad_dict:
                value = padded_array([row[key] for row in batch], **pad_dict[key])
            elif len({row[key].shape for row in batch}) == 1:
                value = np.stack([row[key] for row in batch], axis=0)
            else:
                value = [row[key] for row in batch]
        elif key in string_array_keys:
            value = np.stack([row[key] for row in batch], axis=0)
        else:
            value = [row[key] for row in batch]

        (collated if key in model_inputs else unused)[key] = value
    return collated, unused
