"""Optimizer, schedule and trainer parity of the port against the JAX
package, and the port's CLI on synthetic speechbci files, all on the CPU.

* every scheduler's value at every step equals optax's (rtol 1e-5: optax
  evaluates in float32), and one AdamW update equals ``optax.adamw``;
* the JAX ``Trainer`` and the port's ``Trainer(device="cpu")`` on the same
  tiny speechbci-shaped dataset, with the same weights, float32 compute
  and dropout / noise off: the same batches in the same order, and the
  per-step train loss within rtol 1e-4 over 4 steps (across an epoch
  boundary and a partial batch);
* the same for NDT1-mlm (``configs/trainer_ssl_ndt1.yaml``'s schema: ``base``
  dataset, left-side padding, cosine schedule, a ``force_active`` ``co-smooth``
  masker so that nothing is random), on the dense path and on the flash path
  (JAX in interpret mode, the port on the plain version of its kernels);
* ``llm_bci_tpu_torch.main`` on synthetic ``.mat`` files for 2 steps, with
  the CER metric fns called, and on a spike pickle for 3 mlm steps.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_bci_tpu.config import DictConfig, to_plain_dict
from llm_bci_tpu.training.optim import build_optimizer as jax_build_optimizer
from llm_bci_tpu.training.optim import build_schedule as jax_build_schedule
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.training import optim
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

def port_cfg(cfg):
    """The same config as the port's own ``DictConfig``."""
    return PortDictConfig(to_plain_dict(cfg))


SCHEDULES = {
    "linear_no_warmup": {"scheduler": "linear", "warmup_pct": 0.0},
    "linear_warmup": {"scheduler": "linear", "warmup_pct": 0.1},
    "cosine": {"scheduler": "cosine", "warmup_pct": 0.3, "div_factor": 25},
    "cosine_clamped": {"scheduler": "cosine", "warmup_pct": 0.0, "div_factor": 10},
    "step": {"scheduler": "step", "gamma": 0.5},
    "step_accum": {"scheduler": "step", "gamma": 0.9, "gradient_accumulation_steps": 3},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("steps_per_epoch,num_epochs", [(7, 3), (1, 2)])
def test_schedule_matches_optax(name, steps_per_epoch, num_epochs):
    cfg = DictConfig({"lr": 2e-3, **SCHEDULES[name]})
    ref, ref_total = jax_build_schedule(cfg, steps_per_epoch, num_epochs)
    ours, total = optim.build_schedule(port_cfg(cfg), steps_per_epoch, num_epochs)
    assert total == ref_total
    for count in range(total + 3):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name} step {count}")


def test_adamw_step_matches_optax():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    cfg = DictConfig({"lr": 1e-2, "wd": 0.05, "eps": 1e-8, "scheduler": "linear"})

    tx, _ = jax_build_optimizer(cfg, steps_per_epoch=3, num_epochs=1)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, schedule = optim.build_optimizer([p], port_cfg(cfg), steps_per_epoch=3, num_epochs=1)
    for i, g in enumerate(grads):
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        opt.param_groups[0]["lr"] = schedule(i)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ trainer parity

C, V = 8, 41


def speechbci_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        T = int(rng.integers(30, 41))
        S = int(rng.integers(2, 7))
        idx = rng.integers(1, V, size=S)
        rows.append({
            "spikes": rng.normal(size=(T, C)).astype(np.float32),
            "phonemes_idx": idx,
            "phonemes": [f"P{j}" for j in idx],
            "sentence": f"sentence {seed} {i}",
            "block_idx": np.asarray(i % 2),
            "day_idx": np.asarray(0),
        })
    return rows


def trainer_config(tmp_path):
    pad = lambda: {"dim": 0, "side": "right", "value": 0, "truncate": None, "min_length": None}
    return DictConfig({
        "seed": 3,
        "savestring": "parity",
        "verbosity": 3,
        "dirs": {"checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": None},
        "training": {"num_epochs": 2, "train_batch_size": 4, "test_batch_size": 4,
                     "max_steps": 4, "save_on_preemption": False},
        # one batch shard: the conftest gives JAX 8 virtual CPU devices, and
        # params this small stay replicated on the fsdp axis
        "parallelism": {"data": 1, "fsdp": -1},
        "precision": {"compute_dtype": "float32"},
        "model": {
            "model_class": "NDT1",
            "encoder": {
                "masker": {"neuron": {"active": False}},
                "smooth_and_noise": {"noise": False},
                "embedder": {"n_channels": C, "input_dim": 8, "max_F": 64, "dropout": 0.0,
                             "stack": {"active": True, "size": 4, "stride": 2}},
                "transformer": {"n_layers": 2, "hidden_size": 32, "n_heads": 4,
                                "inter_size": 32, "dropout": 0.0},
            },
        },
        "data": {"dataset_class": "decoding"},
        "method": {
            "model_kwargs": {"method_name": "ctc", "vocab_size": V, "blank_id": 0,
                             "zero_infinity": True},
            "dataset_kwargs": {"targets_name": "phonemes_idx"},
            "dataloader_kwargs": {"pad_dict": {
                k: pad() for k in ("spikes", "spikes_mask", "spikes_timestamp", "targets",
                                   "targets_mask")
            }},
            "metric_kwargs": {},
        },
        "optimizer": {"lr": 1e-3, "wd": 5e-5, "scheduler": "cosine", "warmup_pct": 0.3},
    })


def recorder(log):
    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        log.append((float(np.asarray(outputs["loss"])), tuple(unused_inputs["sentence"])))
        return 0.0

    return record


def test_trainer_loss_curve_matches_jax_trainer(tmp_path):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
    from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax

    dataset = {"train": speechbci_rows(10, 0), "test": speechbci_rows(4, 1)}
    jax_log, port_log = [], []
    jt = JaxTrainer(trainer_config(tmp_path / "jax"), dataset=dataset,
                    metric_fns={"rec": recorder(jax_log)})
    params = jax.device_get(jt.state.params)
    pt = PortTrainer(port_cfg(trainer_config(tmp_path / "port")), dataset=dataset,
                     metric_fns={"rec": recorder(port_log)}, device="cpu")
    pt.model.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)

    jt.train()
    pt.train()
    assert len(jax_log) == len(port_log) == 4
    assert [s for _, s in port_log] == [s for _, s in jax_log]
    assert len(port_log[2][1]) == 2        # the epoch's partial batch
    np.testing.assert_allclose([l for l, _ in port_log], [l for l, _ in jax_log], rtol=1e-4)
    assert pt.n_updates == 4


def mlm_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"spikes": rng.poisson(1.5, size=(int(rng.integers(20, 31)), C)).astype(np.float32),
             "sentence": f"trial {seed} {i}"} for i in range(n)]


def mlm_trainer_config(tmp_path, flash):
    cfg = trainer_config(tmp_path)
    pad = lambda: {"dim": 0, "side": "left", "value": 0, "truncate": None, "min_length": None}
    enc = cfg["model"]["encoder"]
    enc["masker"] = {"neuron": {"active": True, "force_active": True, "mode": "co-smooth",
                                "channels": [0, 5], "zero_ratio": 1.0}}
    enc["embedder"]["stack"] = {"active": False}
    enc["transformer"]["flash_attention"] = flash
    cfg["data"] = {"dataset_class": "base", "test_name": "val"}
    cfg["method"] = {
        "model_kwargs": {"method_name": "mlm", "log_input": True, "loss": "poisson_nll"},
        "dataset_kwargs": {},
        "dataloader_kwargs": {"pad_dict": {
            k: pad() for k in ("spikes", "spikes_mask", "spikes_timestamp")}},
        "metric_kwargs": {},
    }
    cfg["optimizer"] = {"lr": 1e-3, "wd": 0.01, "scheduler": "cosine", "warmup_pct": 0.15,
                        "div_factor": 25}
    return cfg


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_mlm_trainer_loss_curve_matches_jax_trainer(tmp_path, flash):
    from llm_bci_tpu.ops import flash_attention as jfa
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
    from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax

    dataset = {"train": mlm_rows(10, 0), "val": mlm_rows(4, 1)}
    jax_log, port_log = [], []
    jfa.set_interpret_mode(flash)
    try:
        jt = JaxTrainer(mlm_trainer_config(tmp_path / "jax", flash), dataset=dataset,
                        metric_fns={"rec": recorder(jax_log)})
        params = jax.device_get(jt.state.params)
        jt.train()
    finally:
        jfa.set_interpret_mode(False)
    pt = PortTrainer(port_cfg(mlm_trainer_config(tmp_path / "port", flash)), dataset=dataset,
                     metric_fns={"rec": recorder(port_log)}, device="cpu")
    pt.model.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)
    assert pt.model.encoder._use_flash_now(30) == flash
    pt.train()
    assert len(jax_log) == len(port_log) == 4
    assert [s for _, s in port_log] == [s for _, s in jax_log]
    # rtol 1e-4 as for CTC: float32 sums in another order over 4 updates
    np.testing.assert_allclose([l for l, _ in port_log], [l for l, _ in jax_log], rtol=1e-4)
    batch, _ = next(iter(pt.train_dataloader))
    assert batch["spikes_mask"][:, 0].min() == 0 and batch["spikes_mask"][:, -1].all()  # left


def test_port_main_on_a_spike_pickle(tmp_path):
    import pickle

    from llm_bci_tpu_torch import main as port_main

    with open(tmp_path / "spikes.pkl", "wb") as f:
        pickle.dump({"train": mlm_rows(6, 0), "val": mlm_rows(3, 1)}, f)
    args = port_main.parse_args([
        "-c", "configs/trainer_ssl_ndt1.yaml",
        "-k", "data.data_load=file", f"data.data_dir={tmp_path}", "data.data_file=spikes.pkl",
        f"dirs.checkpoint_dir={tmp_path / 'ck'}", "dirs.log_dir=null", "verbosity=3",
        "training.max_steps=3", "training.eval_every=3", "training.save_every=null",
        "training.train_batch_size=4", "training.test_batch_size=4",
        "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
        "model.encoder.masker.neuron.ratio=0.3", "model.encoder.embedder.stack.active=false",
        "model.encoder.transformer.flash_attention=true", "precision.compute_dtype=float32",
        "model.encoder.transformer.n_layers=1", "model.encoder.transformer.hidden_size=16",
        "model.encoder.transformer.n_heads=2", "model.encoder.transformer.inter_size=16",
        "model.encoder.embedder.input_dim=8", "--device", "cpu",
    ])
    trainer = port_main.main(args)
    assert trainer.model.method_name == "mlm" and trainer.model.decoder.out_features == C
    assert trainer.model.encoder.embedder.embed_spikes.in_features == C   # inferred
    (h,) = trainer.eval_history
    assert np.isfinite(h["train_avg_loss"]) and h["train_avg_loss"] > 0
    # eval leaves the masker off (no force_active): nothing to reconstruct
    assert h["test_avg_loss"] == 0.0
    # a training forward masks about ``ratio`` of the valid bins
    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    trainer.model.train()
    out = trainer.model(**batch, generator=trainer.generator)
    share = float(out.n_examples) / (float(batch["spikes_mask"].sum()) * C)
    assert 0.2 < share < 0.4
    # data_load: ibl reads the session data/IBL/<eid>, which this checkout does not hold
    with pytest.raises(FileNotFoundError):
        port_main.main(port_main.parse_args(
            ["-c", "configs/trainer_ssl_ndt1.yaml", "--device", "cpu"]))


def test_port_main_on_speechbci_files(tmp_path):
    import chip_smoke
    from llm_bci_tpu_torch import main as port_main

    chip_smoke.write_mat_dataset(str(tmp_path / "mat"), n_train=6, n_test=4, n_holdout=4,
                                 bins=(60, 64), channels=8)
    calls = []
    real = port_main.make_cer_fns

    def counted(vocab, blank_id):
        fns = real(vocab, blank_id)
        wrapped = []
        for fn in fns:
            def w(*a, _fn=fn, **k):
                calls.append(k.get("prepared") is not None)
                return _fn(*a, **k)
            if hasattr(fn, "prepare"):
                w.prepare = fn.prepare
            wrapped.append(w)
        return tuple(wrapped)

    port_main.make_cer_fns = counted
    try:
        args = port_main.parse_args([
            "-c", "configs/trainer_ctc_ndt1.yaml",
            "-k", f"data.data_dir={tmp_path / 'mat'}", f"dirs.checkpoint_dir={tmp_path / 'ck'}",
            f"dirs.log_dir={tmp_path / 'logs'}", "training.max_steps=2", "training.eval_every=2",
            "training.save_every=2",
            "training.train_batch_size=4", "training.test_batch_size=4", "verbosity=3",
            "precision.compute_dtype=float32", "model.encoder.transformer.n_layers=1",
            "model.encoder.transformer.hidden_size=16", "model.encoder.transformer.n_heads=2",
            "model.encoder.transformer.inter_size=16", "model.encoder.embedder.input_dim=8",
            "model.encoder.embedder.stack.size=4", "model.encoder.embedder.stack.stride=2",
            "--device", "cpu",
        ])
        trainer = port_main.main(args)
    finally:
        port_main.make_cer_fns = real
    assert trainer.model.encoder.embedder.embed_spikes.in_features == 16  # n_channels inferred
    (h,) = trainer.eval_history
    assert np.isfinite(h["train_avg_loss"]) and np.isfinite(h["test_avg_loss"])
    assert 0.0 <= h["test_avg_metrics"]["CER"] <= 2.0
    assert 0.0 <= h["train_avg_metrics"]["CER"] <= 2.0
    # 2 train steps with the prepared argmax, 1 eval batch without
    assert calls == [True, True, False]
    step_dir = tmp_path / "ck" / "ndt1_ctc" / "STEP2"
    assert sorted(os.listdir(step_dir)) == ["decoder.pt", "encoder.pt", "encoder_config.yaml", "optimizer.pt",
                                        "trainer_config.yaml"]
