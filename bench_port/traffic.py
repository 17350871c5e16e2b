"""The general trial generator: a configuration's dataset, made from a traffic
file's parameters and the run's seed.

A traffic file (``bench_port/traffic/<name>.json``) gives the trials'
lengths in bins (``bins``: bands ``[[least, most, weight], ...]``, a band
drawn by its weight and a length uniformly inside it), the feature blocks that make the channels
(``features``: a name, a distribution, its channel count), where the method
takes phoneme targets their length as a share of the trial's bins
(``targets_per_bin``: ``[least, most]``, drawn uniformly), and how the
trainer runs the traffic (``trainer``: nested overrides) and the benchmark
times it (``run``).

The set of trial and target lengths is the same for every seed (drawn from
``sizes_seed``); the seed permutes it and draws the bins' contents, so two
seeds train on the same amount of work in another order. Contents are made
on the device in one call a feature block and copied to the host once, as
the speechbci loader hands the trainer host arrays. The longest length of
the bands, and the longest target it allows, are always in the set, so the
padded widths are the same for every seed.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _seed(seed: int, salt: int) -> int:
    return int(np.random.SeedSequence((int(seed), salt)).generate_state(1)[0])


def sizes(traffic: Dict, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(trial lengths, target lengths) of ``n`` trials: a fixed set, in the
    seed's order. Target lengths are 0 where the traffic has none."""
    rng = np.random.default_rng(int(traffic.get("sizes_seed", 0)))
    b = np.asarray(traffic["bins"], dtype=np.float64)      # rows (least, most, weight)
    pick = rng.choice(len(b), size=n, p=b[:, 2] / b[:, 2].sum())
    bins = rng.integers(b[pick, 0].astype(np.int64), b[pick, 1].astype(np.int64) + 1)
    bins[0] = int(b[:, 1].max())
    if "targets_per_bin" in traffic:
        lo, hi = (float(x) for x in traffic["targets_per_bin"])
        tl = np.maximum(1, np.rint(bins * rng.uniform(lo, hi, size=n))).astype(np.int64)
        tl[0] = max(1, int(np.rint(bins[0] * hi)))
    else:
        tl = np.zeros(n, dtype=np.int64)
    perm = np.random.default_rng(_seed(seed, 0x0D)).permutation(n)
    return bins[perm], tl[perm]


def padding_share(traffic: Dict, n: int) -> float:
    """Share of the padded bins that are padding, over the whole set: every
    batch is padded to the set's longest trial."""
    bins, _ = sizes(traffic, n, 0)
    return float(1.0 - bins.sum() / (len(bins) * bins.max()))


def make_trials(config: Dict, traffic: Dict, seed: int, device, vocab: List[str] = None
                ) -> Dict[str, List[dict]]:
    """``{"train": rows, "test": rows}``: each row a trial as the speechbci
    (or spike-pickle) loader gives it, with ``trial`` its index."""
    n_train, n_test = int(config["train_trials"]), int(config["test_trials"])
    n = n_train + n_test
    bins, tl = sizes(traffic, n, seed)
    total = int(bins.sum())
    gen = torch.Generator(device).manual_seed(_seed(seed, 0xDA7A))
    blocks = []
    for block in traffic["features"]:
        shape = (total, int(block["channels"]))
        if block["dist"] == "poisson":
            rate = torch.full(shape, float(block.get("rate", 1.0)), device=device)
            blocks.append(torch.poisson(rate, generator=gen))
        elif block["dist"] == "normal":
            blocks.append(torch.randn(shape, generator=gen, device=device))
        else:
            raise ValueError(f"unknown distribution {block['dist']!r}")
    spikes = torch.cat(blocks, dim=1).float().cpu().numpy()
    parts = np.split(spikes, np.cumsum(bins)[:-1])
    ids = None
    if tl.any():
        vocab_size = int(traffic["vocab_size"])
        ids = np.random.default_rng(_seed(seed, 0x7A)).integers(1, vocab_size, size=int(tl.sum()))
        ids = np.split(ids, np.cumsum(tl)[:-1])
    rows = []
    for i in range(n):
        row = {"spikes": parts[i], "trial": np.asarray(i, dtype=np.int64)}
        if ids is not None:
            row["phonemes_idx"] = ids[i]
            row["phonemes"] = [vocab[j] if vocab else str(j) for j in ids[i]]
            row["sentence"] = f"trial {i}"
            row["block_idx"] = np.asarray(i % 4, dtype=np.int64)
            row["day_idx"] = np.asarray(i % 2, dtype=np.int64)
        rows.append(row)
    return {"train": rows[:n_train], "test": rows[n_train:]}
