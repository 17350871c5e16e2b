"""The port's copies of the JAX package's host-side eval and data code, held
against the originals on the same seeded inputs: bits-per-spike and the
regression summaries (``eval/metrics.py``), CTC prefix beam search
(``eval/ctc_decode.py``) and the IBL loader (``data/ibl.py``, on a small
``datasets`` session written to disk), and ``llm_bci_tpu_torch.main`` with
``data_load: ibl``."""
import numpy as np
import pytest

from llm_bci_tpu.data import ibl as jibl
from llm_bci_tpu.eval import ctc_decode as jctc
from llm_bci_tpu.eval import metrics as jmetrics
from llm_bci_tpu_torch.data import ibl as tibl
from llm_bci_tpu_torch.eval import ctc_decode as tctc
from llm_bci_tpu_torch.eval import metrics as tmetrics

T, N, TRIALS, EID = 12, 10, 16, "session_aligned"


def test_metrics_equal_the_jax_package():
    rng = np.random.default_rng(0)
    rates = rng.uniform(0.2, 3.0, size=(6, T, N))
    spikes = rng.poisson(rates).astype(np.float64)
    spikes[0, :, 3] = np.nan                       # a missing bin is left out
    assert tmetrics.bits_per_spike(rates, spikes) == jmetrics.bits_per_spike(rates, spikes)
    assert np.isnan(tmetrics.bits_per_spike(rates[..., :1], 0 * spikes[..., :1]))
    assert tmetrics.neg_log_likelihood(rates, spikes) == jmetrics.neg_log_likelihood(rates,
                                                                                     spikes)
    targets, preds = rng.normal(size=(5, 7)), rng.normal(size=(5, 7))
    assert tmetrics.metrics_list(targets, preds) == jmetrics.metrics_list(targets, preds)
    labels = rng.integers(0, 3, size=9)
    assert tmetrics.metrics_list(labels, labels[::-1], ["acc"]) == jmetrics.metrics_list(
        labels, labels[::-1], ["acc"])
    assert tmetrics.r2_score_np(targets, preds) == jmetrics.r2_score_np(targets, preds)


@pytest.mark.parametrize("seed", range(3))
def test_ctc_prefix_beam_search_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=(14, 6))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lm = lambda prefix, c: -0.1 * (c + len(prefix))
    for kw in ({"beam_width": 4, "n_best": 3}, {"beam_width": 8, "n_best": 5, "blank_id": 2},
               {"beam_width": 6, "n_best": 2, "lm": lm, "lm_weight": 0.5}):
        assert tctc.ctc_prefix_beam_search(lp, **kw) == jctc.ctc_prefix_beam_search(lp, **kw)
    ref, got = jctc.CTCPrefixDecoder(beam_width=5), tctc.CTCPrefixDecoder(beam_width=5)
    for chunk in (lp[:3], lp[3:9], lp[9:]):
        assert got.step(chunk) == ref.step(chunk)
    assert got.n_best(4) == ref.n_best(4)
    assert got.best() == tctc.ctc_prefix_beam_search(lp, beam_width=5)[0]


def write_ibl_session(root):
    """An IBL-format session saved with ``datasets``: CSR spikes per trial,
    neuron uuids / regions / depths, a static and a dynamic behaviour (one
    trial without the dynamic one: a trace of T bins, or a scalar); as saved
    splits (``EID``: train 10, val 3,
    test 3) and as one table for the loader to split (``EID_flat``)."""
    from datasets import Dataset, DatasetDict
    from scipy.sparse import csr_array

    rng = np.random.default_rng(0)
    cols = {k: [] for k in ("spikes_sparse_data", "spikes_sparse_indices",
                            "spikes_sparse_indptr", "spikes_sparse_shape", "cluster_uuids",
                            "cluster_regions", "cluster_depths", "choice", "wheel-speed",
                            "wheel-mean")}
    for i in range(TRIALS):
        csr = csr_array(rng.poisson(0.4, size=(T, N)).astype(np.float32))
        cols["spikes_sparse_data"].append(csr.data.tolist())
        cols["spikes_sparse_indices"].append(csr.indices.tolist())
        cols["spikes_sparse_indptr"].append(csr.indptr.tolist())
        cols["spikes_sparse_shape"].append([T, N])
        cols["cluster_uuids"].append([f"uuid{n:03d}" for n in range(N)])
        cols["cluster_regions"].append([("CA1", "VISp", "LP")[n % 3] for n in range(N)])
        cols["cluster_depths"].append((np.arange(N) * 20.0).tolist())
        cols["choice"].append(float(rng.choice([-1.0, 1.0])))
        cols["wheel-speed"].append(None if i == 5 else rng.normal(size=T).tolist())
        cols["wheel-mean"].append(None if i == 5 else float(rng.normal()))
    flat = Dataset.from_dict(cols)
    flat.save_to_disk(str(root / f"{EID}_flat"))
    DatasetDict({"train": flat.select(range(10)), "val": flat.select(range(10, 13)),
                 "test": flat.select(range(13, 16))}).save_to_disk(str(root / EID))
    return str(root)


@pytest.fixture(scope="module")
def ibl_dir(tmp_path_factory):
    return write_ibl_session(tmp_path_factory.mktemp("ibl"))


BEHAVIOURS = {"static_behaviours": ["choice"], "dynamic_behaviours": ["wheel-mean"],
              "norm_behaviours": True}


@pytest.mark.parametrize("eid,kw,splits", [
    (EID, {}, ["test", "train", "val"]),
    (EID, BEHAVIOURS, ["test", "train", "val"]),
    (f"{EID}_flat", {"test_size": 0.25, "seed": 3, **BEHAVIOURS}, ["test", "train"]),
], ids=["saved_splits", "behaviours", "test_size"])
def test_ibl_loader_gives_the_jax_package_s_rows(ibl_dir, eid, kw, splits):
    ref = jibl.load_ibl_dataset(ibl_dir, eid, **kw)
    got = tibl.load_ibl_dataset(ibl_dir, eid, **kw)
    assert sorted(got) == sorted(ref) == splits
    assert sum(len(rows) for rows in got.values()) == TRIALS - (1 if kw else 0)
    for split, rows in ref.items():
        assert len(got[split]) == len(rows)
        for a, b in zip(got[split], rows):
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert got["train"][0]["spikes"].shape == (T, N)


def test_ibl_loader_keeps_traces_beside_a_missing_trial(ibl_dir):
    """Dynamic behaviours that are traces (T bins a trial) with one trial
    missing: the JAX package's loader cannot stack them; the port's copy loads
    them and drops the same trial."""
    kw = {"dynamic_behaviours": ["wheel-speed"], "norm_behaviours": True}
    with pytest.raises(ValueError):
        jibl.load_ibl_dataset(ibl_dir, EID, **kw)
    got = tibl.load_ibl_dataset(ibl_dir, EID, **kw)
    scalar = tibl.load_ibl_dataset(ibl_dir, EID, dynamic_behaviours=["wheel-mean"])
    assert [len(rows) for rows in got.values()] == [len(rows) for rows in scalar.values()]
    trace = np.concatenate([row["wheel-speed"] for rows in got.values() for row in rows])
    assert all(row["wheel-speed"].shape == (T,) for rows in got.values() for row in rows)
    np.testing.assert_allclose([trace.mean(), trace.std()], [0.0, 1.0], atol=1e-5)


def test_port_main_builds_an_ndt1_trainer_on_an_ibl_session(ibl_dir, tmp_path):
    from llm_bci_tpu_torch import main as port_main

    args = port_main.parse_args([
        "-c", "configs/trainer_ssl_ndt1.yaml", "-k", f"data.data_dir={ibl_dir}",
        f"data.eid={EID}",
        f"dirs.checkpoint_dir={tmp_path / 'ck'}", "dirs.log_dir=null", "verbosity=3",
        "training.max_steps=2", "training.eval_every=2", "training.save_every=null",
        "training.train_batch_size=4", "training.test_batch_size=4",
        "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
        "model.encoder.masker.neuron.ratio=0.3", "model.encoder.embedder.stack.active=false",
        "model.encoder.transformer.n_layers=1", "model.encoder.transformer.hidden_size=16",
        "model.encoder.transformer.n_heads=2", "model.encoder.transformer.inter_size=16",
        "model.encoder.embedder.input_dim=8", "model.encoder.embedder.max_F=16",
        "precision.compute_dtype=float32", "--device", "cpu",
    ])
    trainer = port_main.main(args)
    assert trainer.model.encoder.embedder.embed_spikes.in_features == N     # inferred
    assert len(trainer.train_dataset) == 10 and len(trainer.test_dataset) == 3
    (h,) = trainer.eval_history
    assert np.isfinite(h["train_avg_loss"]) and h["train_avg_loss"] > 0
