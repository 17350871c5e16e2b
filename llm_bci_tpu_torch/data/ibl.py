# Mirrors llm_bci_tpu/data/ibl.py (host code that imports no JAX): the port keeps its own copy,
# with one repair: a dynamic behaviour's traces beside a missing trial load.
"""IBL electrophysiology dataset loader.

Reimplements the reference ``data_utils/ibl_dataset.py:30-83``: HF
``load_from_disk`` dataset per session eid, CSR-sparse → dense binned
spikes, optional train/test split, neuron metadata (uuids/regions/depths),
static+dynamic behaviors with optional normalization.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np


def get_binned_spikes_from_sparse(
    data_list, indices_list, indptr_list, shape_list
) -> np.ndarray:
    """Per-trial CSR triplets → dense (n_trials, seq_len, n_channels) float32
    (reference ``data_utils/ibl_dataset.py:42-45``)."""
    from scipy.sparse import csr_array

    dense = [
        csr_array(
            (data_list[i], indices_list[i], indptr_list[i]), shape=shape_list[i]
        ).toarray()
        for i in range(len(data_list))
    ]
    return np.asarray(dense, dtype=np.float32)


def load_ibl_dataset(
    data_dir: str,
    eid: str,
    test_size: Optional[float] = None,
    static_behaviours: Optional[List[str]] = None,
    dynamic_behaviours: Optional[List[str]] = None,
    norm_behaviours: bool = False,
    seed: int = 1,
    **kwargs,
) -> Dict[str, List[Dict[str, Any]]]:
    from datasets import load_from_disk

    static_behaviours = static_behaviours or []
    dynamic_behaviours = dynamic_behaviours or []

    raw_dataset = load_from_disk(os.path.join(data_dir, eid))
    if test_size is not None:
        raw_dataset = raw_dataset.train_test_split(test_size=test_size, seed=seed)

    dataset_dict: Dict[str, List[Dict[str, Any]]] = {}
    for split in raw_dataset.keys():
        cols: Dict[str, Any] = {}
        cols["spikes"] = get_binned_spikes_from_sparse(
            raw_dataset[split]["spikes_sparse_data"],
            raw_dataset[split]["spikes_sparse_indices"],
            raw_dataset[split]["spikes_sparse_indptr"],
            raw_dataset[split]["spikes_sparse_shape"],
        )
        names = raw_dataset[split].column_names
        if "cluster_uuids" in names:
            cols["neuron_uuids"] = raw_dataset[split]["cluster_uuids"]
        if "cluster_regions" in names:
            cols["neuron_regions"] = raw_dataset[split]["cluster_regions"]
        if "cluster_depths" in names:
            cols["neuron_depths"] = np.asarray(
                raw_dataset[split]["cluster_depths"], dtype=np.float32
            )
        for beh in static_behaviours:
            cols[beh] = raw_dataset[split][beh]
        exclude_idx: set = set()
        for beh in dynamic_behaviours:
            vals = raw_dataset[split][beh]
            for i, v in enumerate(vals):
                if v is None:
                    exclude_idx.add(i)
            # One float32 array a trial: a trace of T bins or a scalar. (The JAX
            # package stacks them into one array, which fails on traces
            # beside a missing trial; the trials kept are the same.)
            cols[beh] = [
                np.asarray(v if v is not None else np.nan, dtype=np.float32) for v in vals
            ]
        dataset_dict[split] = [
            {k: np.atleast_1d(cols[k][i]) for k in cols}
            for i in range(len(cols["spikes"]))
            if i not in exclude_idx
        ]

    if norm_behaviours:
        for beh in dynamic_behaviours:
            all_trials = np.stack(
                [row[beh] for rows in dataset_dict.values() for row in rows], axis=0
            )
            mean, std = all_trials.mean(), all_trials.std()
            for rows in dataset_dict.values():
                for row in rows:
                    row[beh] = (row[beh] - mean) / std

    return dataset_dict
