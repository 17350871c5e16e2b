"""``training.chain_steps`` in the port's trainer, held against the JAX
trainer's on the CPU (``llm_bci_tpu/training/trainer.py``'s chain: exact-K
groups of one batch signature, capped at eval / save / profile / budget
boundaries, per-step readback and bookkeeping):

* a chained run equals the single-step run bit for bit (on the CPU a chain's
  steps run eagerly on the step graph's slots), with the same metric calls,
  at ``eval_every=3`` over 2-step epochs (chains capped at evals and epoch
  ends), and with ``gradient_accumulation_steps: 2`` under ``chain_steps: 3``;
* the port's chained run against the JAX trainer's ``chain_steps: 2`` run
  from the same weights, stochastic parts off: the same steps chained and
  single (a partial batch breaks a group) and per-step losses within rtol
  1e-4 (the parity tolerance of ``tests/test_torch_port_trainer.py``);
* a CTC model's ``None`` output fields survive a chain;
* a preemption requested inside a chain saves at the chain's end, tagged
  with the step the state holds;
* under a gloo group of 2 ranks a chain's steps run eagerly on the step
  graph's slots and equal ``chain_steps: 1``'s.
"""
import os

import jax
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.training import step_graph
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer
from tests import _torch_parallel_worker as W
from tests.test_torch_port_trainer import speechbci_rows, trainer_config
from tests.test_trainer_ndt1 import base_config, synth_dataset


def port_cfg(cfg, **training):
    plain = to_plain_dict(cfg)
    plain["training"].update(training)
    return PortDictConfig(plain)


def losses_of(log):
    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        log.append(float(np.asarray(outputs["loss"])))
        return log[-1]

    return record


class Pattern:
    """Which steps of a run were chained (``c<K>``) and which single (``s``),
    recorded by wrapping the trainer's ``chain`` and ``train_step``."""

    def __init__(self, trainer):
        self.calls = []
        chain, single = trainer.chain, trainer.train_step

        def traced_chain(items):
            self.calls.append(f"c{len(items)}")
            yield from chain(items)

        def traced_single(batch):
            self.calls.append("s")
            return single(batch)

        trainer.chain, trainer.train_step = traced_chain, traced_single


def run_port(cfg, dataset, chain, **training):
    log = []
    trainer = PortTrainer(port_cfg(cfg, chain_steps=chain, **training), dataset=dataset,
                          metric_fns={"rate": losses_of(log)}, device="cpu")
    pattern = Pattern(trainer)
    trainer.train()
    return trainer, log, pattern.calls


def assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for pa, pb in zip(a.trainable, b.trainable):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[pa][key], b.optimizer.state[pb][key])


def test_chain_matches_single_steps_bit_for_bit(tmp_path):
    """The JAX test's schedule (max_steps 7, eval_every 3, 2 steps an epoch,
    masker, noise and dropout on): steps 1-2 and 5-6 chain, 3, 4 and 7 run
    singly (an eval or the budget inside, or an epoch's last batch)."""
    dataset = synth_dataset()
    runs = {}
    for chain in (1, 2):
        cfg = base_config(tmp_path / f"c{chain}")
        runs[chain] = run_port(cfg, dataset, chain, num_epochs=4, max_steps=7, eval_every=3)
    (t1, log1, calls1), (t2, log2, calls2) = runs[1], runs[2]
    assert calls1 == ["s"] * 7
    assert calls2 == ["c2", "s", "s", "c2", "s"]
    assert t1.n_micro == t2.n_micro == 7 and t1.n_updates == t2.n_updates == 7
    # 7 train steps and two evals of one batch each: the same calls either way
    assert len(log1) == len(log2) == 9
    assert log1 == log2
    assert [h["step"] for h in t2.eval_history] == [3, 6]
    drop_rate = lambda hist: [{k: v for k, v in h.items() if k != "samples_per_sec"}
                              for h in hist]
    assert drop_rate(t1.eval_history) == drop_rate(t2.eval_history)
    assert_same_state(t1, t2)
    assert t2.graphs == {}          # freed at the end of train()


def test_chain_with_gradient_accumulation(tmp_path):
    """``gradient_accumulation_steps: 2`` under ``chain_steps: 3``: a chain
    holds steps that close an update and steps that do not (one graph each),
    and the run equals the single-step run bit for bit."""
    dataset = synth_dataset(n_train=48)
    runs = {}
    for chain in (1, 3):
        cfg = base_config(tmp_path / f"c{chain}")
        cfg["optimizer"]["gradient_accumulation_steps"] = 2
        runs[chain] = run_port(cfg, dataset, chain, num_epochs=2, max_steps=8)
    (t1, log1, _), (t3, log3, calls3) = runs[1], runs[3]
    assert calls3 == ["c3", "c3", "s", "s"]
    assert t1.n_updates == t3.n_updates == 4 and t3.n_micro == 8
    assert log1 == log3
    assert_same_state(t1, t3)


def test_chain_matches_the_jax_trainer(tmp_path):
    """The JAX trainer's ``chain_steps: 2`` and the port's, from the same
    weights with dropout and noise off, on 3-step epochs whose last batch is
    partial (another signature): the same steps chained and single, and the
    same per-step losses. The JAX side is counted by wrapping its compiled
    step functions on the instance."""
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
    from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax

    dataset = {"train": speechbci_rows(10, 0), "test": speechbci_rows(4, 1)}
    jcfg = trainer_config(tmp_path / "jax")
    jcfg["training"].update(num_epochs=3, max_steps=8, eval_every=4, chain_steps=2)
    jax_log, jax_calls = [], []
    jt = JaxTrainer(jcfg, dataset=dataset, metric_fns={"rate": losses_of(jax_log)})
    chained, single = jt._train_step_chained, jt._train_step

    def jax_chained(state, batches):
        jax_calls.append(f"c{next(iter(batches.values())).shape[0]}")
        return chained(state, batches)

    def jax_single(state, batch):
        jax_calls.append("s")
        return single(state, batch)

    jt._train_step_chained, jt._train_step = jax_chained, jax_single
    weights = ndt1_state_dict_from_jax(jax.device_get(jt.state.params))
    jt.train()

    port_log = []
    pt = PortTrainer(port_cfg(trainer_config(tmp_path / "port"), num_epochs=3, max_steps=8,
                              eval_every=4, chain_steps=2),
                     dataset=dataset, metric_fns={"rate": losses_of(port_log)}, device="cpu")
    pt.model.load_state_dict(weights, strict=True)
    pattern = Pattern(pt)
    pt.train()
    # steps 1-2 chain; 3 is an epoch's partial tail, 4 has an eval inside
    # its chain, 5-6 are a full and a partial batch; 7-8 chain
    assert pattern.calls == jax_calls == ["c2", "s", "s", "s", "s", "c2"]
    assert len(port_log) == len(jax_log) == 8 + 2
    np.testing.assert_allclose(port_log, jax_log, rtol=1e-4)
    assert pt.n_micro == int(np.asarray(jt.state.step)) == 8


def test_chain_keeps_none_output_fields(tmp_path):
    """The CTC outputs leave ``mask`` unset: a chain's steps hand the metric
    fns ``None`` there, as the JAX trainer's chain does."""
    cfg = trainer_config(tmp_path)
    seen = []

    def rate(model, model_inputs, unused_inputs, outputs, **kwargs):
        assert outputs.get("mask") is None
        seen.append(float(outputs["loss"]))
        return seen[-1]

    dataset = {"train": speechbci_rows(16, 0), "test": speechbci_rows(4, 1)}
    trainer = PortTrainer(port_cfg(cfg, num_epochs=2, max_steps=4, chain_steps=2),
                          dataset=dataset, metric_fns={"rate": rate}, device="cpu")
    pattern = Pattern(trainer)
    step_graph.reset_counters()
    trainer.train()
    assert pattern.calls == ["c2", "c2"]
    assert len(seen) == 4 and np.isfinite(seen).all()
    # two graphs' first steps and two more steps, all eager on the CPU
    assert step_graph.EAGER_STEPS == 4 and step_graph.CAPTURES == step_graph.REPLAYS == 0


def test_preemption_inside_a_chain_saves_at_its_end(tmp_path):
    """A preemption requested after a chain's first step is honoured once
    the chain has run: ``STEP3`` (the state's step), not ``STEP1``."""
    cfg = trainer_config(tmp_path)
    dataset = {"train": speechbci_rows(12, 0), "test": speechbci_rows(4, 1)}
    trainer = PortTrainer(port_cfg(cfg, num_epochs=3, max_steps=9, chain_steps=3),
                          dataset=dataset, device="cpu")
    chain = trainer.chain

    def preempted_chain(items):
        for j, outputs in enumerate(chain(items)):
            if j == 0:
                trainer.request_preemption()
            yield outputs

    trainer.chain = preempted_chain
    trainer.train()
    assert trainer.n_micro == 3
    ckpt = os.path.join(str(tmp_path / "ckpt"), "parity")
    assert sorted(d for d in os.listdir(ckpt) if d.startswith("STEP")) == ["STEP3"]
    assert os.listdir(os.path.join(ckpt, "train_state")) == ["3"]


def test_chain_under_a_gloo_group_runs_eagerly(tmp_path):
    """Two gloo ranks at ``data=2``: ``chain_steps: 2`` runs its chains'
    steps eagerly on the step graph's slots and ends where ``chain_steps:
    1`` does, bit for bit."""
    from llm_bci_tpu_torch.training.trainer import build_model

    dataset = {"train": speechbci_rows(16, 0), "test": speechbci_rows(4, 1)}
    data_path = W.dump(dataset, tmp_path / "data.pkl")
    weights = str(tmp_path / "weights.pt")
    torch.manual_seed(0)
    plain = to_plain_dict(trainer_config(tmp_path / "w"))
    torch.save(build_model(W._config(plain, {"data": 1, "fsdp": 1}), torch.device("cpu"))
               .state_dict(), weights)
    cases = []
    for chain in (1, 2):
        cfg = to_plain_dict(trainer_config(tmp_path / f"c{chain}"))
        cfg["training"].update(max_steps=4, chain_steps=chain)
        cases.append((f"c{chain}", "train", dict(plain=cfg, parallelism={"data": 2, "fsdp": 1},
                                                 dataset_path=data_path, weights_path=weights)))
    ranks = W.run_ranks(tmp_path, 2, cases)
    for rank in ranks:
        one, two = rank["c1"], rank["c2"]
        assert "error" not in one and "error" not in two, (one.get("error"), two.get("error"))
        assert one["losses"] == two["losses"] and len(one["losses"]) == 4
        assert one["n_micro"] == two["n_micro"] == 4
    assert ranks[0]["c1"]["model"].keys() == ranks[0]["c2"]["model"].keys()
    for k, v in ranks[0]["c1"]["model"].items():
        assert torch.equal(v, ranks[0]["c2"]["model"][k]), k


def test_captured_gradient_buffers_are_attached_again():
    """A step graph accumulates into the gradient buffers of its capture:
    before a replay the trainer makes them the parameters' gradients again,
    holding the value each gradient has then (zero where it was freed)."""
    a, b, c = (torch.nn.Parameter(torch.zeros(3)) for _ in range(3))
    bufs = [torch.full((3,), 5.0) for _ in range(3)]
    a.grad, b.grad, c.grad = bufs[0], None, torch.arange(3.0)
    PortTrainer._attach_grads(list(zip((a, b, c), bufs)))
    assert a.grad is bufs[0] and b.grad is bufs[1] and c.grad is bufs[2]
    assert a.grad.tolist() == [5.0] * 3 and b.grad.tolist() == [0.0] * 3
    assert c.grad.tolist() == [0.0, 1.0, 2.0]
