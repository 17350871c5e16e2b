"""``training.cache_device_batches`` in the port's trainer
(``llm_bci_tpu_torch/training/batch_cache.py``), each case held against the
JAX trainer's own pool (``_prefetch``, the cases of
``tests/test_trainer_ndt1.py``) on the CPU:

* the first pass streams and keeps its device batches; later shuffled
  epochs gather from the pool in the streaming order, the order of the JAX
  trainer's replay, with the device rows equal to the host rows handed to
  the metric fns, a reshuffled composition, and no batch copied from the
  host after the first pass; a mid-epoch resume's skip is honoured;
* an eval loader replays the cached batches as they are;
* a ``drop_last`` pool with a ragged tail streams (said once), as the JAX
  trainer's does;
* list columns and unused columns replay with their rows;
* chained and cached, a run equals the chained uncached run bit for bit and
  copies batches from the host in its first epoch only;
* under a gloo group of one rank a cached run equals one process's (groups
  of several ranks: ``tests/test_torch_port_cache_batches_parallel.py``).
"""
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.training.batch_cache import PoolRows
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer
from tests.test_trainer_ndt1 import base_config, synth_dataset


def cache_config(tmp_path, **training):
    cfg = base_config(tmp_path)
    cfg["training"].update({"cache_device_batches": True, "max_steps": 100, **training})
    return cfg


def port_trainer(cfg, dataset, **kwargs):
    return PortTrainer(PortDictConfig(to_plain_dict(cfg)), dataset=dataset, device="cpu",
                       **kwargs)


def port_pass(trainer, loader, epoch=None, skip=0):
    """One pass over ``loader`` through the port's pool: the host ``spikes``
    of each batch and its source's kind (after checking its device rows
    against them)."""
    if epoch is not None:
        loader.set_epoch(epoch, skip_batches=skip)
    spikes, kinds = [], []
    for source, model_inputs, _ in trainer.batches(loader, epoch):
        dev = trainer.device_batch(source, model_inputs)
        np.testing.assert_array_equal(dev["spikes"].numpy(), model_inputs["spikes"])
        spikes.append(np.asarray(model_inputs["spikes"]).copy())
        kinds.append(type(source).__name__)
    return spikes, kinds


def jax_pass(trainer, loader, epoch=None, skip=0):
    if epoch is not None:
        loader.set_epoch(epoch, skip_batches=skip)
    out = []
    for dev_batch, model_inputs, _ in trainer._prefetch(loader, epoch=epoch):
        np.testing.assert_allclose(np.asarray(dev_batch["spikes"]), model_inputs["spikes"],
                                   rtol=1e-6)
        out.append(np.asarray(model_inputs["spikes"]).copy())
    return out


def assert_batches_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """The JAX trainer and the port's, cache on, over 24 examples in
    batches of 8: epochs 1-3 in full, epoch 4 resumed after its first batch,
    and two passes over the test loader; a streaming port trainer's epochs
    beside them."""
    from llm_bci_tpu.training import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("cache")
    dataset = synth_dataset(n_train=24)
    jt = JaxTrainer(cache_config(tmp / "jax"), dataset=dataset)
    pt = port_trainer(cache_config(tmp / "port"), dataset)
    stream = port_trainer(base_config(tmp / "stream"), dataset)
    out = {"jax": {}, "port": {}, "kinds": {}, "stream": {}}
    for epoch, skip in ((1, 0), (2, 0), (3, 0), (4, 1)):
        out["jax"][epoch] = jax_pass(jt, jt.train_dataloader, epoch, skip)
        out["port"][epoch], out["kinds"][epoch] = port_pass(pt, pt.train_dataloader, epoch, skip)
        out["stream"][epoch], _ = port_pass(stream, stream.train_dataloader, epoch)
    out["host_batches"] = pt.host_batches
    out["port_eval"] = [list(pt.batches(pt.test_dataloader)) for _ in range(2)]
    out["jax_eval"] = [list(jt._prefetch(jt.test_dataloader)) for _ in range(2)]
    out["eval_host_batches"] = pt.host_batches - out["host_batches"]
    return out


def test_replay_visits_the_streaming_order(pools):
    for epoch in (1, 2, 3):
        assert_batches_equal(pools["port"][epoch], pools["stream"][epoch])
        assert_batches_equal(pools["port"][epoch], pools["jax"][epoch])
    assert pools["kinds"][1] == ["dict"] * 3
    assert pools["kinds"][2] == pools["kinds"][3] == ["PoolRows"] * 3
    # the first pass copied 3 batches from the host; the replays none
    assert pools["host_batches"] == 3


def test_replay_reshuffles_the_composition(pools):
    first = np.sort(np.concatenate(pools["port"][1]).reshape(24, -1), axis=0)
    for epoch in (2, 3):
        np.testing.assert_array_equal(
            first, np.sort(np.concatenate(pools["port"][epoch]).reshape(24, -1), axis=0))
    compositions = lambda e: [np.sort(b.reshape(8, -1), axis=0) for b in pools["port"][e]]
    assert any(not np.array_equal(a, b) for a, b in zip(compositions(2), compositions(3)))


def test_replay_honours_a_mid_epoch_skip(pools):
    assert len(pools["port"][4]) == 2
    assert_batches_equal(pools["port"][4], pools["stream"][4][1:])
    assert_batches_equal(pools["port"][4], pools["jax"][4])


def test_eval_loader_replays_its_cached_batches(pools):
    first, second = pools["port_eval"]
    assert len(first) == len(second) == len(pools["jax_eval"][0]) > 0
    for a, b in zip(first, second):
        assert a is b and isinstance(a[0], dict)
    for a, b in zip(*pools["jax_eval"]):
        assert a is b
    for (dev, _, _), (jax_dev, _, _) in zip(first, pools["jax_eval"][0]):
        np.testing.assert_allclose(dev["spikes"].numpy(), np.asarray(jax_dev["spikes"]),
                                   rtol=1e-6)
    assert pools["eval_host_batches"] == 1


def test_ragged_drop_last_pool_streams(tmp_path, capsys):
    """20 examples in batches of 8 with ``drop_last``: the kept pool covers
    16, so every epoch streams, dropping a fresh tail as the JAX trainer's
    does; the port says so once."""
    from llm_bci_tpu.training import Trainer as JaxTrainer

    dataset = synth_dataset(n_train=20)
    cfg = lambda tag: cache_config(tmp_path / tag, drop_last_train_dataloader=True)
    jt = JaxTrainer(cfg("jax"), dataset=dataset)
    pt = port_trainer(cfg("port"), dataset)
    pt.verbosity = 0
    capsys.readouterr()
    seen = set()
    for _ in range(5):
        jax_batches = jax_pass(jt, jt.train_dataloader)
        port_batches, kinds = port_pass(pt, pt.train_dataloader)
        assert_batches_equal(port_batches, jax_batches)
        assert set(kinds) <= {"dict", "NoneType"}
        seen.update(row.tobytes() for b in port_batches for row in b)
    assert len(seen) > 16
    assert capsys.readouterr().out.count("covers 16/20 examples") == 1


class ListLoader:
    """A shuffled loader without ``epoch_order`` whose model inputs hold a
    list column and whose unused inputs another (the JAX test's)."""

    shuffle = True

    def __init__(self, n=12, bs=4):
        self.dataset = list(range(n))
        self.bs = bs

    def __iter__(self):
        for s in range(0, len(self.dataset), self.bs):
            idx = range(s, s + self.bs)
            yield ({"spikes": np.asarray([[float(i)] * 3 for i in idx], np.float32),
                    "raw": [f"r{i}" for i in idx]},
                   {"meta": [f"m{i}" for i in idx]})


def test_list_columns_replay_with_their_rows(tmp_path):
    from llm_bci_tpu.training import Trainer as JaxTrainer

    dataset = synth_dataset()
    jt = JaxTrainer(cache_config(tmp_path / "jax"), dataset=dataset)
    pt = port_trainer(cache_config(tmp_path / "port"), dataset)
    jax_loader, port_loader = ListLoader(), ListLoader()
    list(jt._prefetch(jax_loader))
    list(pt.batches(port_loader))
    jax_replay = list(jt._prefetch(jax_loader))
    replay = list(pt.batches(port_loader))
    assert len(replay) == len(jax_replay) == 3
    for (source, model_inputs, unused), (jax_dev, jax_inputs, jax_unused) in zip(replay,
                                                                                 jax_replay):
        assert isinstance(source, PoolRows)
        rows = pt.device_batch(source, model_inputs)["spikes"].numpy()
        # the same permutation as the JAX trainer's (its seed + 7)
        np.testing.assert_array_equal(rows, np.asarray(jax_dev["spikes"]))
        assert model_inputs["raw"] == jax_inputs["raw"] and unused["meta"] == jax_unused["meta"]
        for j, row in enumerate(rows):
            i = int(row[0])
            assert model_inputs["raw"][j] == f"r{i}" and unused["meta"][j] == f"m{i}"


def test_cached_chain_equals_the_uncached_chain(tmp_path):
    """``chain_steps: 2`` over three 2-step epochs, masker, noise and
    dropout on: with the cache the same losses and example order bit for
    bit, the later epochs gathered straight into the step graph's slots,
    and batches copied from the host in the first epoch only."""
    dataset = synth_dataset()
    runs = {}
    for cache in (False, True):
        cfg = base_config(tmp_path / f"cache{cache}")
        cfg["training"].update(num_epochs=3, max_steps=6, chain_steps=2,
                               cache_device_batches=cache)
        log = []

        def record(model, model_inputs, unused_inputs, outputs, log=log, **kwargs):
            log.append((float(outputs["loss"]), float(np.sum(model_inputs["spikes"]))))
            return 0.0

        trainer = port_trainer(cfg, dataset, metric_fns={"rec": record})
        trainer.train()
        runs[cache] = (log, trainer.host_batches, trainer.n_micro)
    assert runs[True][0] == runs[False][0] and len(runs[True][0]) == 6
    assert runs[False][1] == 6 and runs[True][1] == 2
    assert runs[True][2] == runs[False][2] == 6


def test_cache_under_a_one_rank_group_equals_one_process(tmp_path):
    """A gloo group of one rank (the plan applied: FSDP2 over a mesh of
    one) pools and replays as one process does: the same losses and example
    order over three epochs, and batches copied from the host in the first
    epoch only. Groups of 2 and 4 ranks: ``_cache_batches_parallel.py``."""
    import torch.distributed as dist

    dataset = synth_dataset()
    runs = {}
    for group in (False, True):
        cfg = cache_config(tmp_path / f"group{group}", num_epochs=3, max_steps=6)
        log = []

        def record(model, model_inputs, unused_inputs, outputs, log=log, **kwargs):
            log.append((float(outputs["loss"]), float(np.sum(model_inputs["spikes"]))))
            return 0.0

        if group:
            dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                    rank=0, world_size=1)
        try:
            trainer = port_trainer(cfg, dataset, metric_fns={"rec": record})
            assert trainer.distributed == group
            trainer.train()
        finally:
            if group:
                dist.destroy_process_group()
        runs[group] = (log, trainer.host_batches, trainer.n_micro)
    assert runs[True][0] == runs[False][0] and len(runs[True][0]) == 6
    assert runs[True][1:] == runs[False][1:] == (2, 6)
