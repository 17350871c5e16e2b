"""``training.cache_device_batches`` under a process group, on gloo CPU
ranks: every rank pools every row of the global batches (its own time range
under ``sp``) and gathers its ``data`` rows of each replayed batch.

Two groups (``tests/_torch_parallel_worker.py``, each spawned once for the
module), 2 ranks and 4 ranks, train 3 epochs of 9 rows in batches of 4 (a
last batch of one row, which ``data`` does not divide and every rank holds
whole), float32, an eval every epoch, once streaming and once from the pool:

* the debug NDT1 ``ctc`` at ``data=2`` (2 ranks) and at ``data=2 x fsdp=2``
  (4 ranks); an NDT1 ``ctc`` stacking 32/4 at ``sp=2`` (the pool keeps each
  rank's bins and their halo; gradients clipped); the debug int8 BCI at
  ``tp=2``;
* the cached run equals the streaming run bit for bit: losses, evals, the
  whole final state, and every device batch that did not stream equal to
  what ``Trainer.to_device`` cuts from the same host batch;
* each rank copies batches from the host in its first epoch only (train and
  eval), and its pool holds every row;
* ``chain_steps: 2`` with the pool at ``data=2`` (a chain's steps eager on
  the step graph's slots) equals the unchained streaming run;
* the cached ``data=2`` losses within rtol 1e-4 of the JAX trainer's cached
  run at ``{data: 2, fsdp: 4}`` on the conftest's 8 virtual CPU devices,
  from the same weights (``ndt1_state_dict_from_jax``).
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import DictConfig as JaxDictConfig
from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax

from tests import _torch_parallel_worker as W
from tests.test_bci import synth_bci_dataset
from tests.test_torch_port_bci import trainer_config as bci_config
from tests.test_torch_port_sequence_parallel import _ctc324, _rows, _weights
from tests.test_torch_port_trainer import speechbci_rows, trainer_config

N_TRAIN, BATCH, EPOCHS = 9, 4, 3       # batches of 4, 4 and 1 rows
STEPS = 3 * EPOCHS
HOST_FIRST_EPOCH = 3 + 1               # 3 train batches, the test set's one
JAX = dict(rtol=1e-4)
# name: (ranks, parallelism, config)
MESHES = {"data2": (2, {"data": 2, "fsdp": 1}, "ndt1"),
          "data2_fsdp2": (4, {"data": 2, "fsdp": 2}, "ndt1"),
          "sp2": (2, {"data": 1, "fsdp": 1, "sp": 2}, "stacked"),
          "tp2": (2, {"data": 1, "fsdp": 1, "tp": 2}, "bci")}


def _plain(cfg, tag, **training):
    plain = to_plain_dict(cfg)
    plain["savestring"] = tag
    plain["training"].update(train_batch_size=BATCH, test_batch_size=BATCH,
                             num_epochs=EPOCHS, max_steps=None, eval_every=3,
                             save_every=None, **training)
    return plain


def _jax_run(plain, dataset):
    """The JAX trainer's cached ``{data: 2, fsdp: 4}`` run: its initial
    weights as a port state dict and its per-step losses."""
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    cfg = copy.deepcopy(plain)
    cfg["parallelism"] = {"data": 2, "fsdp": 4}
    cfg["training"].update(cache_device_batches=True, eval_every=None)
    jt = JaxTrainer(JaxDictConfig(cfg), dataset=dataset, metric_fns={"rec": record})
    return jt, ndt1_state_dict_from_jax(jax.device_get(jt.state.params)), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cache_parallel")
    data = {"ndt1": {"train": speechbci_rows(N_TRAIN, 0), "test": speechbci_rows(4, 1)},
            "stacked": {"train": _rows(N_TRAIN, 4, (40, 64)), "test": _rows(4, 5, (40, 64))},
            "bci": synth_bci_dataset(n_train=N_TRAIN, n_test=4)}
    paths = {k: W.dump(v, tmp / f"{k}.pkl") for k, v in data.items()}
    plains = {"ndt1": _plain(trainer_config(tmp), "ndt1"),
              "stacked": _plain(_ctc324(tmp), "stacked"),
              "bci": _plain(bci_config(tmp, "int8"), "bci")}
    jt, jax_weights, jax_losses = _jax_run(plains["ndt1"], data["ndt1"])
    weights = {"ndt1": os.path.join(str(tmp), "ndt1.pt")}
    torch.save(jax_weights, weights["ndt1"])
    for k in ("stacked", "bci"):
        weights[k] = _weights(tmp, plains[k], k)

    def case(name, config, parallelism, **training):
        plain = copy.deepcopy(plains[config])
        plain["savestring"] = name
        return (name, "train_pooled", dict(plain=plain, parallelism=parallelism,
                                           dataset_path=paths[config],
                                           weights_path=weights[config], **training))

    groups = {}
    for tag, (n, par, config) in MESHES.items():
        groups.setdefault(n, []).extend(
            [case(f"{tag}_stream", config, par), case(f"{tag}_cache", config, par,
                                                     cache_device_batches=True)])
    groups[2].append(case("data2_chain_cache", "ndt1", MESHES["data2"][1], chain_steps=2,
                          cache_device_batches=True))
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        pending = {}
        for n, cases in groups.items():
            os.makedirs(tmp / f"ranks{n}")
            pending[n] = pool.submit(W.run_ranks, tmp / f"ranks{n}", n, cases)
        jt.train()                        # while the ranks run
        ranks = {n: future.result() for n, future in pending.items()}
    by_name = {}
    for n, results in ranks.items():
        for name in results[0]:
            by_name[name] = [r[name] for r in results]
    return {"ranks": by_name, "jax": jax_losses}


def _ok(results):
    for r in results:
        assert "error" not in r, r.get("error")
    return results


def _assert_same_run(got, want, what):
    """Two runs' ranks equal bit for bit: losses (the metric fn's record of
    every train step and eval batch), evals, the whole final state rank 0
    gathers."""
    for rank, (a, b) in enumerate(zip(got, want)):
        assert a["losses"] == b["losses"] and len(a["losses"]) == STEPS + EPOCHS, (what, rank)
        drop_rate = lambda hist: [{k: v for k, v in h.items() if k != "samples_per_sec"}
                                  for h in hist]
        assert drop_rate(a["eval"]) == drop_rate(b["eval"]) and len(a["eval"]) == EPOCHS
        assert a["n_micro"] == b["n_micro"] == STEPS
    state, want_state = got[0]["model"], want[0]["model"]
    assert state.keys() == want_state.keys() and state
    for k, v in want_state.items():
        assert torch.equal(state[k], v), (what, k)


@pytest.mark.parametrize("tag", list(MESHES))
def test_cached_run_equals_streaming(runs, tag):
    cached = _ok(runs["ranks"][f"{tag}_cache"])
    stream = _ok(runs["ranks"][f"{tag}_stream"])
    _assert_same_run(cached, stream, tag)
    for rank in cached:
        # epoch 1 keeps 3 batches, epochs 2-3 gather 6; the test set's one
        # batch kept by the first eval and replayed by the other two
        assert rank["sources"] == {"dict": 3 + EPOCHS, "PoolRows": 6}, rank["sources"]
        assert rank["unequal"] == [], rank["unequal"][:5]


@pytest.mark.parametrize("tag", list(MESHES))
def test_host_batches_are_the_first_epochs(runs, tag):
    for cached, stream in zip(_ok(runs["ranks"][f"{tag}_cache"]),
                              _ok(runs["ranks"][f"{tag}_stream"])):
        assert cached["host_batches"] == HOST_FIRST_EPOCH
        assert stream["host_batches"] == STEPS + EPOCHS
        assert cached["pool_bytes"] > 0 and stream["pool_bytes"] is None


def test_every_rank_pools_every_row_in_its_time_range(runs):
    """The pool holds the global batches' rows on every rank: the same
    bytes at ``data=2`` as at ``data=2 x fsdp=2``, and under ``sp=2`` the
    rank's bins and halo of the 64, fewer than a rank holding them all."""
    data2 = [r["pool_bytes"] for r in runs["ranks"]["data2_cache"]]
    assert data2[0] == data2[1] == runs["ranks"]["data2_fsdp2_cache"][0]["pool_bytes"]
    # the rank's batches at data=2: its 2 rows of 4, and the one-row batch whole
    for rank in _ok(runs["ranks"]["data2_cache"]):
        assert {s[0] for k, s in rank["shapes"] if k == "spikes"} == {2, 1}
    for rank in _ok(runs["ranks"]["sp2_cache"]):
        bins = {s[1] for k, s in rank["shapes"] if k == "spikes"}
        assert len(bins) == 1 and 32 < bins.pop() < 64, rank["shapes"]


def test_chained_pool_equals_unchained_streaming(runs):
    chained = _ok(runs["ranks"]["data2_chain_cache"])
    _assert_same_run(chained, _ok(runs["ranks"]["data2_stream"]), "chain")
    for rank in chained:
        # epoch by epoch: a chain of two steps and the single one-row step,
        # every step eager on the CPU, none captured
        assert rank["graph"] == (STEPS, 0, 0)
        assert rank["host_batches"] == HOST_FIRST_EPOCH and rank["unequal"] == []


def test_cached_data2_matches_the_jax_trainer(runs):
    losses = _ok(runs["ranks"]["data2_cache"])[0]["losses"]
    train = [x for i, x in enumerate(losses) if i % 4 != 3]    # an eval after each 3 steps
    assert len(runs["jax"]) == len(train) == STEPS
    np.testing.assert_allclose(train, runs["jax"], **JAX)
