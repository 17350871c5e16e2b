"""The port's entry points and the trainer's small leftovers, on the CPU.

* ``llm_bci_tpu_torch.entry.entry(device="cpu")``: the NDT1-CTC forward loss
  at the shapes of ``__graft_entry__.entry()``, with the JAX weights carried
  across, within atol 1e-5 of the JAX loss;
* ``data_load: file`` on a ``torch.save`` file (dicts of numpy arrays, which
  needs ``weights_only=False``) through the port's ``main``;
* datasets named by the config: ``data.json_dataset_name``, and a ``str``
  dataset, are JSON files;
* ``profile: {start_step, num_steps, dir}`` writes a Chrome trace of exactly
  ``num_steps`` steps with CPU activities;
* evaluating never moves the training stream: NDT1-mlm with a
  ``force_active`` random masker and dropout, 4 steps with ``eval_every: 1``
  and with no eval, ends with the same parameters and generator state.
"""
import json
import os

import jax
import numpy as np
import torch

from llm_bci_tpu_torch import main as port_main
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests.test_torch_port_trainer import mlm_rows, port_cfg
from tests.test_trainer_ndt1 import base_config, synth_dataset


def test_entry_loss_matches_graft_entry():
    import __graft_entry__ as graft
    from llm_bci_tpu_torch.entry import entry

    jfn, (params, jbatch) = graft.entry()
    fn, (model, batch) = entry(device="cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(np.shape(v)) for k, v in jbatch.items()}
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)
    model.load_state_dict(ndt1_state_dict_from_jax(jax.device_get(params)), strict=True)
    loss = fn(model, batch)
    assert loss.ndim == 0 and not loss.requires_grad and not model.training
    np.testing.assert_allclose(float(loss), float(jfn(params, jbatch)), atol=1e-5, rtol=0)
    # the port's own seeded weights: the same loss on every call
    fn2, (model2, batch2) = entry(device="cpu")
    assert torch.equal(fn2(model2, batch2), entry(device="cpu")[0](*entry(device="cpu")[1]))


CLI = [
    "-c", "configs/trainer_ssl_ndt1.yaml", "-k", "data.data_load=file", "dirs.log_dir=null",
    "verbosity=3", "training.max_steps=2", "training.eval_every=2", "training.save_every=null",
    "training.train_batch_size=4", "training.test_batch_size=4",
    "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
    "model.encoder.embedder.stack.active=false", "precision.compute_dtype=float32",
    "model.encoder.transformer.n_layers=1", "model.encoder.transformer.hidden_size=16",
    "model.encoder.transformer.n_heads=2", "model.encoder.transformer.inter_size=16",
    "model.encoder.embedder.input_dim=8",
]


def test_port_main_on_a_torch_saved_dataset(tmp_path):
    torch.save({"train": mlm_rows(6, 0), "val": mlm_rows(3, 1)}, tmp_path / "spikes.pt")
    args = port_main.parse_args(CLI + [
        f"data.data_dir={tmp_path}", "data.data_file=spikes.pt",
        f"dirs.checkpoint_dir={tmp_path / 'ck'}", "--device", "cpu"])
    trainer = port_main.main(args)
    (h,) = trainer.eval_history
    assert trainer.n_micro == 2 and np.isfinite(h["train_avg_loss"])


def test_datasets_named_by_the_config_are_json_files(tmp_path):
    ds = synth_dataset(n_train=8, n_test=4)
    path = tmp_path / "ds.json"
    with open(path, "w") as f:
        json.dump({split: [{k: np.asarray(v).tolist() for k, v in row.items()} for row in rows]
                   for split, rows in ds.items()}, f)
    cfg = base_config(tmp_path)
    cfg["data"]["json_dataset_name"] = str(path)
    from_config = PortTrainer(port_cfg(cfg), device="cpu")
    from_str = PortTrainer(port_cfg(base_config(tmp_path)), dataset=str(path), device="cpu")
    for trainer in (from_config, from_str):
        assert len(trainer.train_dataset) == 8
        trainer.train()
        assert trainer.n_micro == 1 and np.isfinite(trainer.evaluate()[0])
    assert torch.equal(from_config.model.decoder.weight, from_str.model.decoder.weight)


def test_profiler_writes_a_chrome_trace_of_num_steps(tmp_path, capsys):
    cfg = base_config(tmp_path)
    cfg["training"].update({"max_steps": 5, "num_epochs": 10})
    cfg["profile"] = {"start_step": 2, "num_steps": 2, "dir": str(tmp_path / "prof")}
    cfg["verbosity"] = 1
    trainer = PortTrainer(port_cfg(cfg), dataset=synth_dataset(n_train=24), device="cpu")
    trainer.train()
    (name,) = os.listdir(tmp_path / "prof")
    assert name == "smoke_steps2-3.trace.json"
    assert f"Profiler trace written to {tmp_path / 'prof' / name}" in capsys.readouterr().out
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and not any(e.get("cat") == "kernel" for e in events)
    # two steps: two optimizer updates inside the trace
    assert sum(e.get("name") == "Optimizer.step#AdamW.step" for e in events) == 2


def test_evaluation_does_not_move_the_training_stream(tmp_path):
    trainers = []
    for root, eval_every in (("a", 1), ("b", None)):
        cfg = base_config(tmp_path / root)
        cfg["training"].update({"max_steps": 4, "num_epochs": 10, "eval_every": eval_every,
                                "save_on_preemption": False})
        cfg["model"]["encoder"]["masker"]["neuron"]["force_active"] = True
        trainer = PortTrainer(port_cfg(cfg), dataset=synth_dataset(n_train=24), device="cpu")
        trainer.train()
        trainers.append(trainer)
    with_eval, without = trainers
    assert len(with_eval.eval_history) == 4 and not without.eval_history
    # the evals drew their masks (force_active) from the eval generator
    assert with_eval.eval_history[0]["test_avg_loss"] > 0
    for (name, a), b in zip(with_eval.model.state_dict().items(),
                            without.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(with_eval.generator.get_state(), without.generator.get_state())
