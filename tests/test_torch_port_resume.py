"""Full train-state checkpoint and resume of the port's ``Trainer``
(``training/checkpoint.py``), the counterpart of the JAX package's resume
tests (``tests/test_trainer_ndt1.py``, ``tests/test_main_cli.py``,
``tests/test_checkpoint_overlay.py``), on the CPU.

Exactness is bit for bit: a run saved at step 4 of 7 (mid-epoch 2) and
resumed consumes the uninterrupted run's batches 5-7, and ends with the same
losses, evals and parameters, with dropout, noise and a ``force_active``
masker drawing from the generators, and inside an accumulation window. The
JAX trainer and the port's, resumed in mid-epoch on the same config, consume
the same examples at the same global steps and label their evals and saves
alike.
"""
import json
import os

import numpy as np
import pytest
import torch

from llm_bci_tpu_torch import main as port_main
from llm_bci_tpu_torch.training import checkpoint
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests.test_torch_port_trainer import port_cfg
from tests.test_trainer_ndt1 import base_config, synth_dataset


def make_cfg(root, max_steps, save_every=None, eval_every=None, **optimizer):
    cfg = base_config(root)
    cfg["training"].update({"max_steps": max_steps, "num_epochs": 10, "save_every": save_every,
                            "eval_every": eval_every, "metric_lag": 1,
                            "save_on_preemption": False})
    # the eval draws its masks too: a force_active masker
    cfg["model"]["encoder"]["masker"]["neuron"]["force_active"] = True
    cfg["optimizer"].update(optimizer)
    return port_cfg(cfg)


def capture(log):
    """A metric fn that records each training step's spikes batch and loss
    (the port's eval hands it a model in eval mode; a flax module has no
    ``training``, so the JAX trainer's evals are recorded too)."""
    def cap(model, model_inputs, unused_inputs, outputs, **kwargs):
        if getattr(model, "training", True):
            log.append((np.asarray(model_inputs["spikes"]).copy(), float(outputs["loss"])))
        return 0.0

    return cap


def run(cfg, dataset, resume=False):
    log = []
    trainer = PortTrainer(cfg, dataset=dataset, metric_fns={"cap": capture(log)}, device="cpu")
    step = trainer.resume_from() if resume else 0
    trainer.train()
    return trainer, log, step


def assert_same_run(a, b, n_tail):
    """``b`` replays the last ``n_tail`` steps of ``a`` and ends in its state."""
    (ta, log_a, _), (tb, log_b, _) = a, b
    train_a = log_a[-n_tail:]
    assert len(log_b) == n_tail
    for (sa, la), (sb, lb) in zip(train_a, log_b):
        np.testing.assert_array_equal(sa, sb)
        assert la == lb
    for (name, pa), pb in zip(ta.model.state_dict().items(), tb.model.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert ta.n_micro == tb.n_micro and ta.n_updates == tb.n_updates
    assert torch.equal(ta.generator.get_state(), tb.generator.get_state())


def test_resumed_stream_and_params_are_exact(tmp_path):
    ds = synth_dataset(n_train=24)        # 3 batches an epoch: step 4 is mid-epoch 2
    full = run(make_cfg(tmp_path / "full", 7, eval_every=2), ds)
    part = run(make_cfg(tmp_path / "part", 4, save_every=4, eval_every=2), ds)
    for (sa, la), (sb, lb) in zip(full[1][:4], part[1]):
        np.testing.assert_array_equal(sa, sb)
        assert la == lb
    resumed = run(make_cfg(tmp_path / "part", 7, eval_every=2), ds, resume=True)
    assert resumed[2] == 4
    assert_same_run(full, resumed, 3)
    # the eval at step 6 drew the same masks from the restored eval generator
    assert full[0].eval_history[-1]["step"] == resumed[0].eval_history[-1]["step"] == 6
    for key in ("test_avg_loss", "train_avg_loss"):
        assert full[0].eval_history[-1][key] == resumed[0].eval_history[-1][key]
    assert torch.equal(full[0].eval_generator.get_state(), resumed[0].eval_generator.get_state())
    ts = os.path.join(resumed[0].checkpoint_dir, "train_state")
    assert sorted(os.listdir(ts)) == ["4"]
    assert sorted(os.listdir(os.path.join(ts, "4"))) == [
        "meta.json", "model.pt", "optimizer.pt", "trainer.pt"]


def test_mid_accumulation_resume_is_exact(tmp_path):
    ds = synth_dataset(n_train=24)
    full = run(make_cfg(tmp_path / "full", 6, gradient_accumulation_steps=2), ds)
    part = run(make_cfg(tmp_path / "part", 3, save_every=3, gradient_accumulation_steps=2), ds)
    assert part[0].n_updates == 1 and part[0].n_micro == 3
    _, parts = checkpoint.load_train_state(os.path.join(part[0].checkpoint_dir, "train_state"))
    assert parts["trainer"]["grads"] and parts["trainer"]["n_micro"] == 3
    resumed = run(make_cfg(tmp_path / "part", 6, gradient_accumulation_steps=2), ds, resume=True)
    assert_same_run(full, resumed, 3)
    assert resumed[0].n_updates == 3


def day_cfg(root, max_steps, save_every=None):
    from llm_bci_tpu.config import DictConfig

    cfg = base_config(root)
    cfg["data"]["dataset_class"] = "day"
    cfg["method"]["model_kwargs"] = {"method_name": "ctc", "vocab_size": 7, "blank_id": 0,
                                     "zero_infinity": True}
    cfg["method"]["dataset_kwargs"] = {"targets_name": "targets", "batch_size": 4}
    pad = {"dim": 0, "side": "right", "value": 0, "truncate": None, "min_length": None}
    cfg["method"]["dataloader_kwargs"]["pad_dict"]["targets"] = DictConfig(dict(pad))
    cfg["method"]["dataloader_kwargs"]["pad_dict"]["targets_mask"] = DictConfig(dict(pad))
    cfg["training"].update({"train_batch_size": 1, "test_batch_size": 1, "max_steps": max_steps,
                            "num_epochs": 10, "save_every": save_every, "metric_lag": 1,
                            "save_on_preemption": False})
    return port_cfg(cfg)


def test_resume_keeps_the_day_dataset_composition(tmp_path):
    # 3 days x 8 trials, day-batches of 4: 6 loader batches an epoch
    ds = synth_dataset(n_train=24, n_test=8, with_targets=True)
    full = run(day_cfg(tmp_path / "full", 9), ds)
    assert all(s.shape[0] == 4 for s, _ in full[1])
    run(day_cfg(tmp_path / "part", 4, save_every=4), ds)
    resumed = run(day_cfg(tmp_path / "part", 9), ds, resume=True)
    assert_same_run(full, resumed, 5)


def test_resume_warns_on_changed_dataloader_geometry(tmp_path, capsys):
    ds = synth_dataset(n_train=24)
    run(make_cfg(tmp_path, 4, save_every=4), ds)
    cfg = make_cfg(tmp_path, 6)
    cfg["training"]["train_batch_size"] = 4          # 3 -> 6 steps an epoch
    capsys.readouterr()
    assert PortTrainer(cfg, dataset=ds, device="cpu").resume_from() == 4
    assert "different dataloader geometry" in capsys.readouterr().out
    assert PortTrainer(make_cfg(tmp_path, 6), dataset=ds, device="cpu").resume_from() == 4
    assert "different dataloader geometry" not in capsys.readouterr().out
    with open(os.path.join(tmp_path, "ckpt", "smoke", "resume_meta.json")) as f:
        assert json.load(f) == {"steps_per_epoch": 3, "train_batch_size": 8,
                                "train_dataset_len": 24}


def test_resume_past_the_budget_does_nothing(tmp_path, capsys):
    ds = synth_dataset(n_train=24)
    run(make_cfg(tmp_path, 4, save_every=4), ds)
    cfg = make_cfg(tmp_path, 4)
    cfg["verbosity"] = 1
    trainer, log, step = run(cfg, ds, resume=True)
    assert step == 4 and log == [] and trainer.n_micro == 4
    assert "Nothing to do: resumed at step 4 with a budget of 4 steps" in capsys.readouterr().out


def test_incomplete_train_state_is_ignored(tmp_path, capsys):
    ds = synth_dataset(n_train=24)
    trainer = run(make_cfg(tmp_path, 4, save_every=2), ds)[0]
    ts = os.path.join(trainer.checkpoint_dir, "train_state")
    assert sorted(os.listdir(ts)) == ["2", "4"]
    # a save cut before its move into place, and a step directory without
    # its meta.json (a copy cut short)
    os.makedirs(os.path.join(ts, ".tmp-9-1"))
    os.makedirs(os.path.join(ts, "8"))
    with open(os.path.join(ts, "8", "model.pt"), "wb") as f:
        f.write(b"\x80\x02trunc")
    capsys.readouterr()
    assert PortTrainer(make_cfg(tmp_path, 6), dataset=ds, device="cpu").resume_from() == 4
    assert "incomplete" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        PortTrainer(make_cfg(tmp_path / "empty", 6), dataset=ds, device="cpu").resume_from()


def test_keeps_the_newest_three_and_replaces_a_step_saved_again(tmp_path):
    d = str(tmp_path / "ts")
    for step in (1, 2, 3, 4, 4):
        checkpoint.save_train_state(d, step, {"x": torch.full((2,), float(step))})
    assert sorted(os.listdir(d)) == ["2", "3", "4"]
    step, parts = checkpoint.load_train_state(d)
    assert step == 4 and torch.equal(parts["x"], torch.full((2,), 4.0))


def test_main_cli_resume_continues_the_step_count(tmp_path, capsys):
    import pickle

    from tests.test_torch_port_trainer import mlm_rows

    with open(tmp_path / "spikes.pkl", "wb") as f:
        pickle.dump({"train": mlm_rows(8, 0), "val": mlm_rows(4, 1)}, f)

    def cli(*extra):
        return port_main.main(port_main.parse_args([
            "-c", "configs/trainer_ssl_ndt1.yaml",
            "-k", "data.data_load=file", f"data.data_dir={tmp_path}", "data.data_file=spikes.pkl",
            f"dirs.checkpoint_dir={tmp_path / 'ck'}", "dirs.log_dir=null", "verbosity=0",
            "training.train_batch_size=4", "training.test_batch_size=4",
            "training.eval_every=null", "training.save_every=2",
            "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
            "model.encoder.embedder.stack.active=false", "precision.compute_dtype=float32",
            "model.encoder.transformer.n_layers=1", "model.encoder.transformer.hidden_size=16",
            "model.encoder.transformer.n_heads=2", "model.encoder.transformer.inter_size=16",
            "model.encoder.embedder.input_dim=8", *extra, "--device", "cpu",
        ]))

    capsys.readouterr()
    first = cli("training.max_steps=2", "training.resume=true")
    assert first.n_micro == 2
    assert "No checkpoint to resume from; starting fresh" in capsys.readouterr().out
    second = cli("training.max_steps=4", "training.resume=true")
    assert "Resumed training from step 2" in capsys.readouterr().out
    assert second.n_micro == 4 and second.n_updates == 4
    assert os.path.isdir(tmp_path / "ck" / "ndt1_ssl" / "STEP4")


def test_overlay_keeps_live_values_on_missing_and_mismatched_leaves(capsys):
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 4))
    live = {k: v.clone() for k, v in model.state_dict().items()}
    saved = {"0.weight": torch.ones(2, 3, dtype=torch.float64),     # restored, cast
             "1.weight": torch.ones(4, 5),                          # shape differs: kept
             "stray": torch.zeros(1)}                               # no live leaf: dropped
    assert checkpoint.overlay_model_state(model, saved) == ["0.weight"]
    out = capsys.readouterr().out
    assert "shapes differ" in out and "has no model leaves" in out and "dropped" in out
    sd = model.state_dict()
    assert torch.equal(sd["0.weight"], torch.ones(2, 3)) and sd["0.weight"].dtype == torch.float32
    for key in ("0.bias", "1.weight", "1.bias"):
        assert torch.equal(sd[key], live[key])
    # a generator state of another size keeps the live state
    g = torch.Generator().manual_seed(1)
    before = g.get_state()
    checkpoint.restore_generator(g, torch.zeros(16, dtype=torch.uint8), "generator")
    assert torch.equal(g.get_state(), before) and "kept the live state" in capsys.readouterr().out


def bci_trainer(root, quantize, component_blobs=True, max_steps=2, save_every=2):
    from tests.test_bci import synth_bci_dataset
    from tests.test_torch_port_bci import trainer_config as bci_config

    cfg = bci_config(root, quantize)
    cfg["training"].update({"max_steps": max_steps, "save_every": save_every,
                            "component_blobs": component_blobs})
    return PortTrainer(port_cfg(cfg), dataset=synth_bci_dataset(n_train=8, n_test=4),
                       device="cpu")


def test_bci_resume_without_frozen_leaves_and_across_quantization(tmp_path, capsys):
    from llm_bci_tpu_torch.ops.quant import quantize_int8

    # component_blobs: false leaves the frozen int8 base out of the train state
    trainer = bci_trainer(tmp_path / "slim", "int8", component_blobs=False)
    trainer.train()
    _, parts = checkpoint.load_train_state(trainer.train_state_dir())
    trains = set(trainer.trainable_names)
    assert set(parts["model"]) == trains and any(".lora_" in k for k in trains)
    fresh = bci_trainer(tmp_path / "slim", "int8", component_blobs=False, max_steps=3)
    frozen_before = {k: v.clone() for k, v in fresh.model.state_dict().items()
                     if k in fresh.frozen_state_keys()}
    capsys.readouterr()
    assert fresh.resume_from() == 2
    assert "has no model leaves" in capsys.readouterr().out
    now = fresh.model.state_dict()
    for key, value in frozen_before.items():
        assert torch.equal(now[key], value), key
    for key in trains:
        assert torch.equal(now[key], trainer.model.state_dict()[key]), key
    for a, b in zip(fresh.optimizer.state_dict()["state"].values(),
                    trainer.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))

    # a train state of a float base restored into an int8 model is quantized
    float_run = bci_trainer(tmp_path / "q", None)
    float_run.train()
    int8_run = bci_trainer(tmp_path / "q", "int8", max_steps=3)
    assert int8_run.resume_from() == 2
    w = float_run.model.llm.model.layers[0].mlp.up_proj.weight.detach()
    q, scale = quantize_int8(w.float().numpy().T, axis=0)
    up = int8_run.model.llm.model.layers[0].mlp.up_proj
    assert torch.equal(up.kernel, torch.from_numpy(q))
    assert torch.equal(up.kernel_scale, torch.from_numpy(scale))


def test_jax_and_port_resume_consume_the_same_steps(tmp_path, capsys):
    from llm_bci_tpu.training import Trainer as JaxTrainer

    ds = synth_dataset(n_train=24)
    index = {np.asarray(r["spikes"]).tobytes(): i for i, r in enumerate(ds["train"])}

    def legs(make, root, reuse):
        cfg_b, cfg_c = base_config(root), base_config(root)
        for cfg, max_steps, save_every in ((cfg_b, 4, 4), (cfg_c, 7, 3)):
            cfg["training"].update({"max_steps": max_steps, "num_epochs": 10,
                                    "save_every": save_every, "eval_every": 2, "metric_lag": 1,
                                    "save_on_preemption": False})
            cfg["verbosity"] = 1
        trainer = make(cfg_b)
        trainer.train()
        capsys.readouterr()
        if reuse:
            # the JAX trainer's compiled steps serve the second leg; its state
            # comes from the checkpoint all the same
            for key, value in cfg_c["training"].items():
                trainer.config["training"][key] = value
        else:
            trainer = make(cfg_c)
        steps = []
        trainer.metric_fns = {"cap": capture(steps)}
        assert trainer.resume_from() == 4
        trainer.train()
        printed = capsys.readouterr().out
        labels = [int(line.split("global_step=")[1].rstrip(":"))
                  for line in printed.splitlines() if "global_step=" in line]
        saves = sorted(int(d[4:]) for d in os.listdir(os.path.join(root, "ckpt", "smoke"))
                       if d.startswith("STEP"))
        train_steps = [b for b, _ in steps if b[0].tobytes() in index]      # evals left out
        return [[index[s.tobytes()] for s in batch] for batch in train_steps], labels, saves

    jax_run = legs(lambda cfg: JaxTrainer(cfg, dataset=ds), tmp_path / "jax", reuse=True)
    port_run = legs(lambda cfg: PortTrainer(port_cfg(cfg), dataset=ds, device="cpu"),
                    tmp_path / "port", reuse=False)
    assert len(port_run[0]) == 3 and port_run[1] == [6] and port_run[2] == [4, 6]
    assert port_run == jax_run
