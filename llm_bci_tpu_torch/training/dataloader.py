"""Host-side numpy dataloader (counterpart of
``llm_bci_tpu/training/dataloader.py``).

Re-implemented rather than imported: that module is pure numpy, but
importing it runs ``llm_bci_tpu/training/__init__.py``, which loads the JAX
trainer. The semantics are the same, and the parity tests rely on them:

* :func:`freeze_pad_lengths` pins every pad key whose ``truncate`` is null
  to the maximum length across all given datasets, so every batch of a run
  has one shape;
* :class:`HostDataLoader` visits epoch ``e`` in the order
  ``default_rng((seed, e)).permutation(n)`` (identity when not shuffled) —
  the same batches in the same order as the JAX package's loader.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np


def _shape_rows(dataset):
    """Per-example ``{pad_key: shape}`` read from the raw rows (derived
    columns share their source column's shape)."""
    spikes_name = getattr(dataset, "spikes_name", "spikes")
    targets_name = getattr(dataset, "targets_name", None)
    if hasattr(dataset, "day_datasets"):
        raw = [row for rows in dataset.day_datasets.values() for row in rows]
    else:
        raw = getattr(dataset, "dataset", dataset)
    for row in raw:
        shapes = {}
        for k, v in row.items():
            try:
                shapes[k] = np.shape(v)
            except ValueError:  # ragged sequences have no shape
                continue
        sp = shapes.get(spikes_name)
        if sp is not None and len(sp) >= 1:
            shapes.setdefault("spikes", sp)
            shapes.setdefault("spikes_mask", sp[:1])
            shapes.setdefault("spikes_timestamp", sp[:1])
            shapes.setdefault("spikes_spacestamp", sp[1:2])
        if targets_name is not None and targets_name in shapes:
            shapes.setdefault("targets", shapes[targets_name])
            shapes.setdefault("targets_mask", shapes[targets_name])
        yield shapes


def freeze_pad_lengths(datasets, pad_dict: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Pin ``truncate == min_length`` of every pad key with a null
    ``truncate`` to the maximum along ``dim`` across all ``datasets``."""
    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    pad_dict = copy.deepcopy(pad_dict)
    need = {k: v for k, v in pad_dict.items() if v.get("truncate") is None}
    maxes = {k: 0 for k in need}
    for dataset in datasets:
        for shapes in _shape_rows(dataset):
            for k, spec in need.items():
                shp = shapes.get(k)
                dim = spec.get("dim", 0)
                if shp is not None and len(shp) > dim:
                    maxes[k] = max(maxes[k], shp[dim])
    empty = [k for k in need if maxes[k] == 0]
    if empty:
        raise ValueError(
            f"freeze_pad_lengths: pad keys {empty} were not found in any dataset "
            "row; set an explicit 'truncate' for them in the pad config"
        )
    for k, spec in need.items():
        spec["truncate"] = spec["min_length"] = maxes[k]
    return pad_dict


class HostDataLoader:
    """Batches over a map-style dataset, collated to numpy dicts. The order
    of epoch ``e`` is a pure function of ``(seed, e)``; ``set_epoch`` pins
    the epoch the next ``iter()`` uses, otherwise epochs count 0, 1, ..."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Callable[[List], Tuple[Dict, Dict]],
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = int(seed)
        self._next_epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._next_epoch = int(epoch)

    def epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, int(epoch))).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Tuple[Dict, Dict]]:
        epoch = self._next_epoch
        self._next_epoch = epoch + 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        order = self.epoch_order(epoch)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
