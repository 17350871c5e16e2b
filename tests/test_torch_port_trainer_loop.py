"""The port's ``Trainer`` loop against the JAX trainer's contract, on the CPU
(tiny NDT1-CTC of ``tests/test_torch_port_trainer.py``):

* ``training.metric_lag`` reads the steps' losses and prepared metric inputs
  back in batches: ``metric_lag: 4`` gives the ``eval_history`` (values and
  step labels) of ``metric_lag: 1`` and runs the metric fns once every 4
  steps, with the steps' own outputs;
* ``training.halt_on_nonfinite`` raises ``FloatingPointError`` at the eval of
  a NaN loss, with the JAX trainer's message;
* ``request_preemption()``, and SIGTERM under ``training.save_on_preemption``,
  save ``STEP{n}`` at the next step boundary and return; the SIGTERM handler
  is restored after ``train()``;
* without ``wandb`` and TensorBoard installed, ``log_to_wandb`` says "wandb
  not available; disabling" and ``dirs.log_dir`` is skipped, as in the JAX
  trainer;
* ``llm_bci_tpu_torch.main`` names PhonemeLLM's slice (6, item 10).
"""
import os
import signal
import sys

import numpy as np
import pytest
import torch

from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests.test_torch_port_trainer import port_cfg, speechbci_rows, trainer_config


def build(tmp_path, seed=0, **training):
    cfg = trainer_config(tmp_path)
    cfg["training"].update({"num_epochs": 3, **training})
    dataset = {"train": speechbci_rows(10, 0), "test": speechbci_rows(4, 1)}
    trainer = PortTrainer(port_cfg(cfg), dataset=dataset, device="cpu")
    torch.manual_seed(seed)
    return trainer


def probe(log, trainer):
    """A metric fn with a ``prepare`` hook that records, when it runs, the
    step count it has reached and the values it was handed."""
    def fn(model, model_inputs, unused_inputs, outputs, prepared=None, **kwargs):
        log.append((trainer.n_micro, model.training, tuple(unused_inputs["sentence"]),
                    float(outputs["loss"]), prepared.tolist()))
        return float(prepared.sum())

    fn.prepare = lambda outputs: outputs["preds"].argmax(-1)
    return fn


def test_metric_lag_gives_the_eval_history_of_no_lag(tmp_path):
    runs = {}
    for lag in (1, 4):
        trainer = build(tmp_path / f"lag{lag}", max_steps=8, eval_every=4, metric_lag=lag)
        if lag == 4:
            trainer.model.load_state_dict(runs[1][0].model_init)
        trainer.model_init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        log = []
        trainer.metric_fns = {"probe": probe(log, trainer)}
        trainer.train()
        runs[lag] = (trainer, log)
    (t1, log1), (t4, log4) = runs[1], runs[4]
    strip = lambda hist: [{k: v for k, v in h.items() if k != "samples_per_sec"} for h in hist]
    assert [h["step"] for h in t1.eval_history] == [4, 8]
    assert strip(t4.eval_history) == strip(t1.eval_history)
    # the same entries in the same order (train steps and eval batches) ...
    assert [e[1:] for e in log4] == [e[1:] for e in log1]
    # ... a train step's read back right after it without lag, every 4 steps with it
    assert [e[0] for e in log1 if e[1]] == [1, 2, 3, 4, 5, 6, 7, 8]
    assert [e[0] for e in log4 if e[1]] == [4, 4, 4, 4, 8, 8, 8, 8]
    assert t4.readback.drains == 2 and t1.readback.drains == 8


def test_halt_on_nonfinite_raises_at_the_eval(tmp_path):
    for halt in (False, True):
        trainer = build(tmp_path / str(halt), max_steps=4, eval_every=2, halt_on_nonfinite=halt)
        with torch.no_grad():
            next(p for p in trainer.model.parameters() if p.requires_grad).fill_(float("nan"))
        if not halt:
            trainer.train()
            assert len(trainer.eval_history) == 2
            assert not np.isfinite(trainer.eval_history[0]["train_avg_loss"])
            continue
        with pytest.raises(FloatingPointError, match=r"Non-finite loss at step 2 \(train=nan"):
            trainer.train()
        assert [h["step"] for h in trainer.eval_history] == [2]


@pytest.mark.parametrize("how", ["request_preemption", "SIGTERM"])
def test_preemption_saves_the_step_and_returns(tmp_path, how):
    trainer = build(tmp_path, max_steps=8, eval_every=4, metric_lag=1, save_on_preemption=True)
    caught = []
    ours = lambda signum, frame: caught.append(signum)   # a SIGTERM the trainer missed lands here
    previous = signal.signal(signal.SIGTERM, ours)
    try:
        def preempt(model, model_inputs, unused_inputs, outputs, **kwargs):
            if trainer.n_micro == 3:
                if how == "SIGTERM":
                    os.kill(os.getpid(), signal.SIGTERM)
                else:
                    trainer.request_preemption()
            return 0.0

        trainer.metric_fns = {"preempt": preempt}
        trainer.train()
        assert signal.getsignal(signal.SIGTERM) is ours       # restored after train()
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert caught == []
    assert trainer.n_micro == 3 and trainer.eval_history == [] and not trainer._preempt_flag
    step_dir = os.path.join(trainer.checkpoint_dir, "STEP3")
    assert sorted(os.listdir(step_dir)) == ["model.pt", "optimizer.pt", "trainer_config.yaml"]


def test_wandb_and_tensorboard_absent(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)                    # import raises ImportError
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = trainer_config(tmp_path)
    cfg["log_to_wandb"] = True
    cfg["verbosity"] = 0
    cfg["dirs"]["log_dir"] = str(tmp_path / "logs")
    cfg["training"]["max_steps"] = 2
    trainer = PortTrainer(port_cfg(cfg), device="cpu",
                          dataset={"train": speechbci_rows(8, 0), "test": speechbci_rows(4, 1)})
    assert "wandb not available; disabling" in capsys.readouterr().out
    assert trainer.wandb is None and trainer.writer is None
    trainer.train()
    assert not os.path.exists(tmp_path / "logs")


def test_port_main_takes_phoneme_llm_and_names_itransformer_s_slice(tmp_path):
    from llm_bci_tpu_torch import main as port_main

    rng = np.random.default_rng(0)

    def row():
        ids = rng.integers(3, 32000, size=(8,))
        probs = rng.dirichlet(np.ones(41), size=6).astype(np.float32)
        return {"spikes": probs, "phoneme_probs": probs, "phonemes_mask": np.ones(6, np.int64),
                "input_ids": ids, "attention_mask": np.ones(8, np.int64),
                "input_split": np.atleast_1d(2),
                "targets": np.where(np.arange(8) >= 5, ids, -100)}

    dataset = {"train": [row() for _ in range(4)], "test": [row() for _ in range(2)]}
    args = port_main.parse_args([
        "-k", "model.model_class=PhonemeLLM", "method.model_kwargs.method_name=endtoend",
        "method.model_kwargs.debug=true", "precision.compute_dtype=float32",
        "training.train_batch_size=2", "training.test_batch_size=2",
        f"dirs.checkpoint_dir={tmp_path}", "dirs.log_dir=null", "--device", "cpu"])
    trainer = port_main.build_trainer(args, dataset=dataset)
    assert type(trainer.model).__name__ == "PhonemeLLM"
    assert trainer.model.coupler_in.in_features == 41          # as configured, no surgery
    out = trainer.train_step(trainer.to_device(next(iter(trainer.train_dataloader))[0]))
    assert np.isfinite(float(out["loss"])) and int(out["n_examples"]) == 2 * 3
    # iTransformer (ROADMAP slice 7) goes through the CLI surgery: max_n_bins
    # pinned to the longest trial, the spikes left-padded to it
    args = port_main.parse_args([
        "-k", "model.model_class=iTransformer", "method.model_kwargs.method_name=mlm",
        "model.encoder.embed_region=false", "model.encoder.embedder.max_n_bins=1",
        "model.encoder.hidden_size=8",
        "model.encoder.n_layers=1", "model.encoder.n_heads=2", "model.encoder.max_n_channels=8",
        f"dirs.checkpoint_dir={tmp_path}", "dirs.log_dir=null", "--device", "cpu"])
    rows = [{"spikes": np.zeros((t, 8), np.float32)} for t in (4, 6)]
    trainer = port_main.build_trainer(args, dataset={"train": rows, "test": rows})
    assert type(trainer.model).__name__ == "iTransformer"
    assert trainer.model.config["encoder"]["embedder"]["max_n_bins"] == 6
    assert trainer.config.method.dataloader_kwargs.pad_dict.spikes.side == "left"
