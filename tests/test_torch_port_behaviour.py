"""Behaviour decoding and the CLI surgery of the iTransformer / PatchTST slice:
``llm_bci_tpu_torch.main`` on tiny pickles on the CPU (as
``tests/test_main_cli.py`` runs the repo's ``main.py``), and
``behaviour_decoding_eval`` against the JAX package's on the same
predictions (metrics equal to 1e-12)."""
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from llm_bci_tpu.eval.behaviour_decoding import behaviour_decoding_eval as jax_eval
from llm_bci_tpu_torch import main as port_main
from llm_bci_tpu_torch.eval.behaviour_decoding import behaviour_decoding_eval

REGIONS = ["CA1", "PO", "LP"]


def write_pickle(path, bins=(14, 14), N=10, n=16, seed=0):
    """``{train, test}`` rows with spikes of ``bins`` lengths, region names,
    depths, a choice in {-1, 1} and a wheel trace a trial."""
    rng = np.random.default_rng(seed)

    def rows(k):
        out = []
        for _ in range(k):
            t = int(rng.integers(bins[0], bins[1] + 1))
            out.append({
                "spikes": rng.poisson(1.0, size=(t, N)).astype(np.float32),
                "choice": np.atleast_1d(float(rng.choice([-1.0, 1.0]))),
                "wheel": rng.normal(size=(t,)).astype(np.float32),
                "neuron_regions": [REGIONS[i % 3] for i in range(N)],
                "neuron_depths": rng.uniform(0, 1, size=N).astype(np.float32),
            })
        return out

    with open(path, "wb") as f:
        pickle.dump({"train": rows(n), "test": rows(n // 2)}, f)


def pad(side="left"):
    return {"dim": 0, "side": side, "value": 0, "truncate": None, "min_length": None}


def config(tmp_path, model, method, dataset_class="decoding", targets=None, **mk):
    pads = {k: pad() for k in ("spikes", "spikes_mask", "spikes_timestamp", "spikes_spacestamp")}
    if method == "dyn_behaviour":
        pads["targets"] = pad()
    cfg = {
        "savestring": f"port_{method}", "verbosity": 3,
        "dirs": {"checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": None},
        "training": {"num_epochs": 1, "train_batch_size": 8, "test_batch_size": 8,
                     "max_steps": 2, "eval_every": 2},
        "model": model,
        "data": {"dataset_class": dataset_class, "data_load": "file",
                 "data_dir": str(tmp_path), "data_file": "ds.pkl"},
        "method": {"model_kwargs": {"method_name": method, **mk},
                   "dataset_kwargs": {"targets_name": targets} if targets else {},
                   "dataloader_kwargs": {"pad_dict": pads}},
        "optimizer": {"lr": 1e-3, "scheduler": "cosine"},
        "precision": {"compute_dtype": "float32"},
    }
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def itransformer(**encoder):
    enc = {"embedder": {"mode": "mlp", "max_n_bins": 1, "dropout": 0.1},
           "hidden_size": 16, "n_heads": 2, "n_layers": 1, "max_n_channels": 16,
           "embed_region": True, "embed_depth": False, "dropout": 0.1}
    enc.update(encoder)
    return {"model_class": "iTransformer",
            "masker": {"main": {"force_active": True, "mode": "neuron", "ratio": 0.2}},
            "encoder": enc, "decoder": {"mlp_decoder": False, "use_cls": True}}


def run(cfg_path, *kwargs):
    return port_main.main(port_main.parse_args(["-c", cfg_path, "--device", "cpu",
                                                *(["-k", *kwargs] if kwargs else [])]))


def test_main_itransformer_stat_behaviour(tmp_path):
    write_pickle(str(tmp_path / "ds.pkl"))
    trainer = run(config(tmp_path, itransformer(), "stat_behaviour", targets="choice",
                         loss="xent"))
    regions = trainer.model.config["encoder"]["regions"]
    # the vocabulary is a set's order (the hash seed's); every masker gets it
    assert sorted(regions) == sorted(REGIONS)
    for m in trainer.model.config["masker"].values():
        assert m["target_regions"] == m["mask_regions"] == regions
    row = trainer.dataset["train"][0]
    assert [regions[i] for i in row["neuron_regions_idx"]] == row["neuron_regions"]
    assert trainer.model.config["encoder"]["embedder"]["max_n_bins"] == 14
    # {-1, 1} remapped to contiguous classes; n_labels and the accuracy fn
    assert trainer.model.n_labels == 2
    assert {int(r["choice"][0]) for rows in trainer.dataset.values() for r in rows} == {0, 1}
    (h,) = trainer.eval_history
    assert 0.0 <= h["train_avg_metrics"]["accuracy"] <= 1.0
    _, metrics = trainer.evaluate()
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert trainer.metric_fns["accuracy"].prepare is not None
    acc = behaviour_decoding_eval(trainer, is_cls=True)
    assert set(acc) == {"acc"} and 0.0 <= acc["acc"] <= 1.0


def test_main_itransformer_dyn_behaviour_and_mlm(tmp_path):
    write_pickle(str(tmp_path / "ds.pkl"), bins=(11, 14))
    trainer = run(config(tmp_path, itransformer(embed_region=False), "dyn_behaviour",
                         targets="wheel"))
    assert trainer.model.config["encoder"]["embedder"]["max_n_bins"] == 14
    assert trainer.model.config["encoder"]["regions"] is None
    pads = trainer.config.method.dataloader_kwargs.pad_dict
    assert dict(pads.spikes) == {"dim": 0, "side": "left", "value": 0, "truncate": 14,
                                 "min_length": 14}
    res = behaviour_decoding_eval(trainer, is_cls=False, regression_metrics=["r2", "mse"])
    assert set(res) == {"r2", "mse"} and np.isfinite(list(res.values())).all()
    trainer = run(config(tmp_path, itransformer(), "mlm", dataset_class="base",
                         loss="poisson_nll", log_input=True))
    assert np.isfinite(trainer.eval_history[0]["test_avg_loss"])


def test_main_patchtst_pins_context_and_saves_running_statistics(tmp_path):
    write_pickle(str(tmp_path / "ds.pkl"), bins=(13, 17), N=6)
    model = {"model_class": "PatchTST", "encoder": {
        "patch_length": 4, "patch_stride": 4, "num_hidden_layers": 1, "d_model": 8,
        "num_attention_heads": 2, "ffn_dim": 16, "random_mask_ratio": 0.5}}
    trainer = run(config(tmp_path, model, "mlm", dataset_class="base", loss="poisson_nll"),
                  "training.save_every=2")
    enc = trainer.model.config["encoder"]
    assert (enc["num_input_channels"], enc["context_length"]) == (6, 20)   # 17 -> 20
    for key in ("spikes", "spikes_mask", "spikes_timestamp"):
        spec = dict(trainer.config.method.dataloader_kwargs.pad_dict[key])
        assert spec == {"dim": 0, "side": "left", "value": 0, "truncate": 20, "min_length": 20}
    batch, _ = next(iter(trainer.train_dataloader))
    assert batch["spikes"].shape[1:] == (20, 6)
    # the running statistics moved in training and are in the checkpoint's
    # encoder blob
    saved = torch.load(os.path.join(trainer.checkpoint_dir, "STEP2", "encoder.pt"))
    stats = {k: v for k, v in saved.items() if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 4
    for k, v in stats.items():
        assert torch.equal(v, trainer.model.state_dict()["encoder." + k])
        assert not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))


class ProbeTrainer:
    """What ``behaviour_decoding_eval`` reads of a trainer: ``metric_fns`` and
    an ``evaluate`` that hands each batch's outputs to them."""

    def __init__(self, batches, to):
        self.batches, self.to, self.metric_fns = batches, to, {}

    def evaluate(self, eval_train_set=False):
        for preds, targets in self.batches:
            for fn in self.metric_fns.values():
                fn(None, {}, {}, {"preds": self.to(preds), "targets": self.to(targets),
                                  "loss": self.to(np.zeros((), np.float32))})


@pytest.mark.parametrize("is_cls", [True, False])
def test_behaviour_decoding_eval_equals_the_jax_package(is_cls):
    rng = np.random.default_rng(7)
    if is_cls:
        batches = [(rng.normal(size=(n, 3)).astype(np.float32),
                    rng.integers(0, 3, size=(n, 1)).astype(np.int64)) for n in (8, 8, 5)]
        kw = {}
    else:
        batches = [(rng.normal(size=(n, 20)).astype(np.float32),
                    rng.normal(size=(n, 20)).astype(np.float32)) for n in (8, 3)]
        kw = {"regression_metrics": ["r2", "mse", "mae"]}
    port = behaviour_decoding_eval(ProbeTrainer(batches, torch.from_numpy), is_cls, **kw)
    ref = jax_eval(ProbeTrainer(batches, np.asarray), is_cls, **kw)
    assert port.keys() == ref.keys() == ({"acc"} if is_cls else {"r2", "mse", "mae"})
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-12, err_msg=k)
