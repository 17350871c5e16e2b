"""``training.cache_device_batches``: a dataloader's collated columns kept on
the device after its first complete pass (the port's counterpart of the JAX
trainer's ``_prefetch`` pool and ``_build_cache_columns``,
``llm_bci_tpu/training/trainer.py:688-858``).

:meth:`DeviceBatchCache.batches` yields ``(source, model_inputs,
unused_inputs)`` for each batch of a pass, ``source`` being what the
trainer turns into the rank's device batch (``Trainer.device_batch``):

* ``None`` — stream it: the host arrays of ``model_inputs`` go through
  ``Trainer.to_device``;
* a ``dict`` — the pool's tensors of the batch, kept from the caching pass;
* :class:`PoolRows` — rows of the pool's device columns, gathered on the
  device (``torch.index_select``, into a step graph's slots where given).

What the pool keeps of a batch is ``to_device(..., every_row=True)``'s form:
every row of the global batch, each time-dim key in this rank's ``sp``
range. One process keeps the device batch itself. Under a process group
every rank reads the same host batches (the loaders share their seed), so
every rank keeps every row, and the trainer cuts the rank's ``data`` rows at
each step from the layout of the batch's host arrays
(``Trainer.pooled_batch``): a reshuffled epoch draws rows that another rank
held in the caching pass, and the gathered batch equals what ``to_device``
cuts from the same host batch, bit for bit. So the whole dataset (its rank's
time range) is on every card, where the JAX pool is sharded over ``data``
and XLA's gather moves rows between devices; :attr:`DeviceBatchCache.bytes`
counts a rank's pool.

The first pass over a loader streams and keeps each batch. Only a pass that
ran to its end defines the pool; one cut short (``max_steps`` in mid-epoch,
a break) is rebuilt at the next pass, and says so. A loader that does not
shuffle (eval) then replays the kept batches as they are. A shuffled
loader's later epochs stack the kept batches into one column a key (batches
are freed) and re-batch them by a device gather in the order the streaming
path would visit: the epoch's ``epoch_order`` composed with the inverse of
the caching pass's order (``epoch=None``: a permutation of its own). The
epoch's order goes to the device once; no batch is copied from the host.
Host columns (numpy), list columns and unused columns replay per example, in
the same order. A pool that does not cover the dataset (``drop_last`` with a
ragged tail: the first epoch's shuffle chose which examples were dropped)
streams instead, and says so once (rank 0 prints); so does a caching pass
that began in mid-epoch (a resume). A mid-epoch resume's skip
(``set_epoch(e, skip_batches=k)``) is honoured in replay.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


class PoolRows:
    """Rows ``idx`` (a device index, a global batch's rows in order) of the
    pool's device columns."""

    def __init__(self, columns: Dict[str, torch.Tensor], idx: torch.Tensor):
        self.columns, self.idx = columns, idx

    def signature_batch(self) -> Dict[str, Any]:
        """Meta tensors of the gathered rows' shapes and dtypes."""
        n = self.idx.shape[0]
        return {k: torch.empty((n,) + tuple(c.shape[1:]), dtype=c.dtype, device="meta")
                for k, c in self.columns.items()}


class _Entry:
    def __init__(self):
        self.items: Optional[List[Tuple[Dict[str, Any], Dict, Dict]]] = []
        self.complete = False
        self.n_cached = 0
        self.dataset_order: Optional[np.ndarray] = None
        self.columns: Optional[Dict[str, torch.Tensor]] = None
        self.warned = False


class DeviceBatchCache:
    """The pools of one trainer, one a dataloader. ``keep(model_inputs)``
    copies a batch's host columns to the device in the pool's form (the
    tensors alone); ``say(msg)`` prints."""

    def __init__(self, seed: int, keep: Callable[[Dict], Dict[str, torch.Tensor]],
                 say: Callable[[str], None]):
        self.keep = keep
        self.say = say
        self.entries: Dict[int, _Entry] = {}
        self.order_rng = np.random.default_rng(int(seed) + 7)

    @property
    def bytes(self) -> int:
        """Device bytes the pools hold."""
        total = 0
        for entry in self.entries.values():
            batches = (entry.columns.values() if entry.columns is not None else
                       [t for b, _, _ in entry.items for t in b.values()])
            total += sum(t.numel() * t.element_size() for t in batches)
        return total

    def batches(self, loader, epoch: Optional[int] = None
                ) -> Iterator[Tuple[Any, Dict, Dict]]:
        entry = self.entries.get(id(loader))
        if entry is None or not entry.complete:
            if entry is not None:
                self.say(f"cache_device_batches: the previous pass ended before the epoch did "
                         f"({len(entry.items)} batches cached); rebuilding: the cache engages "
                         "after the first complete pass over the dataloader.")
            entry = self.entries[id(loader)] = _Entry()
            for model_inputs, unused_inputs in loader:
                item = (self.keep(model_inputs), model_inputs, unused_inputs)
                entry.items.append(item)
                yield item
            entry.n_cached = sum(_rows(batch) for batch, _, _ in entry.items)
            if hasattr(loader, "epoch_order"):
                entry.dataset_order = loader.epoch_order(loader.last_epoch)
            entry.complete = True
            return
        if not getattr(loader, "shuffle", False):
            yield from entry.items
            return
        n_dataset = len(getattr(loader, "dataset", ()))
        if n_dataset and entry.n_cached != n_dataset:
            if not entry.warned:
                entry.warned = True
                self.say(f"cache_device_batches: the cached pool covers {entry.n_cached}/"
                         f"{n_dataset} examples (a drop_last tail, or a pass begun in mid-epoch)"
                         ": streaming instead, so that each epoch's composition stays that of "
                         "the streaming path.")
            for model_inputs, unused_inputs in loader:
                yield None, model_inputs, unused_inputs
            return
        if entry.columns is None:
            self._stack(entry)
            self.say(f"cache_device_batches: {int(entry.sizes.sum())} examples pooled on the "
                     f"device, {self.bytes} bytes on each rank")
        n = int(entry.sizes.sum())
        if epoch is not None and entry.dataset_order is not None:
            # the streaming path's order: this epoch's dataset indices, mapped
            # through the inverse of the pool's storage order
            inv = np.empty(n, dtype=np.int64)
            inv[np.asarray(entry.dataset_order[:n], dtype=np.int64)] = np.arange(n)
            order = inv[loader.epoch_order(epoch)]
        else:
            order = np.arange(n)
            self.order_rng.shuffle(order)
        skip, loader._skip_batches = getattr(loader, "_skip_batches", 0), 0
        device = next(iter(entry.columns.values())).device
        dev_order = torch.as_tensor(order, device=device)
        start = 0
        for bi, bs in enumerate(entry.sizes):
            idx = order[start:start + bs]
            rows = PoolRows(entry.columns, dev_order[start:start + bs])
            start += bs
            if bi < skip:
                continue
            model_inputs = {k: v[idx] for k, v in entry.host_columns.items()}
            model_inputs.update({k: [v[i] for i in idx] for k, v in entry.list_columns.items()})
            unused = {k: [v[i] for i in idx] for k, v in entry.unused_columns.items()}
            yield rows, model_inputs, unused

    @staticmethod
    def _stack(entry: _Entry) -> None:
        """The caching pass's batches as one column a key (examples on dim
        0); the batches themselves are freed."""
        items = entry.items
        first_batch, first_inputs, first_unused = items[0]
        entry.columns = {k: torch.cat([b[k] for b, _, _ in items]) for k in first_batch}
        entry.host_columns = {k: np.concatenate([np.asarray(mi[k]) for _, mi, _ in items])
                              for k, v in first_inputs.items() if isinstance(v, np.ndarray)}
        entry.list_columns = {k: [row for _, mi, _ in items for row in mi[k]]
                              for k, v in first_inputs.items() if not isinstance(v, np.ndarray)}
        entry.unused_columns = {k: [row for _, _, ui in items for row in ui[k]]
                                for k in first_unused}
        entry.sizes = np.asarray([_rows(b) for b, _, _ in items])
        entry.items = None


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    return next(iter(batch.values())).shape[0]
