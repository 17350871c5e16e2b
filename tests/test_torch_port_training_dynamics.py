"""The 120-step loss curve of the port against the JAX trainer (``slow``).

The debug NDT1-CTC of ``tests/test_torch_port_trainer.py`` (2 layers x 32,
stacked 4/2) trains 120 steps in the JAX ``Trainer`` and in the port's
``Trainer(device="cpu")`` from the same weights
(``interop.ndt1_state_dict_from_jax``) on the same batches (10 rows in
batches of 4: 40 epochs of three steps, the last of two rows), with AdamW
on the OneCycle schedule (``cosine``) and float32 compute. The stochastic
parts are off, as ``tests/test_training_dynamics_parity.py`` turns them off
(masker, noise, dropout). Every step's loss within rtol 1e-4 and the final
parameters within atol 1e-4 (the attention key biases, whose gradient is
rounding noise, within what Adam can move them): the optimizer's semantics, the schedule and
the loss's scale kept over a whole run, where the 4-step parity tests would
not see a drift.
"""
import jax
import numpy as np
import pytest

from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests import _torch_parallel_worker as W
from tests.test_torch_port_trainer import port_cfg, recorder, speechbci_rows, trainer_config

STEPS = 120
LOSS = dict(rtol=1e-4)
PARAMS = dict(rtol=0.0, atol=1e-4)


def _config(tmp_path):
    cfg = trainer_config(tmp_path)
    cfg["training"].update(max_steps=STEPS, num_epochs=STEPS, eval_every=None,
                           save_every=None)
    return cfg


@pytest.mark.slow
def test_120_step_loss_curve_matches_the_jax_trainer(tmp_path):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    dataset = {"train": speechbci_rows(10, 0), "test": speechbci_rows(4, 1)}
    jax_log, port_log = [], []
    jcfg = _config(tmp_path / "jax")
    enc = jcfg["model"]["encoder"]
    assert not enc["masker"]["neuron"]["active"] and not enc["smooth_and_noise"]["noise"]
    assert enc["embedder"]["dropout"] == enc["transformer"]["dropout"] == 0.0
    assert jcfg["optimizer"]["scheduler"] == "cosine"
    jt = JaxTrainer(jcfg, dataset=dataset, metric_fns={"rec": recorder(jax_log)})
    params = jax.device_get(jt.state.params)
    pt = PortTrainer(port_cfg(_config(tmp_path / "port")), dataset=dataset,
                     metric_fns={"rec": recorder(port_log)}, device="cpu")
    pt.model.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)

    jt.train()
    pt.train()
    assert len(jax_log) == len(port_log) == STEPS and pt.n_updates == STEPS
    assert [s for _, s in port_log] == [s for _, s in jax_log]
    jax_losses = np.array([l for l, _ in jax_log])
    port_losses = np.array([l for l, _ in port_log])
    assert jax_losses[-10:].mean() < 0.8 * jax_losses[:10].mean()      # it learns
    np.testing.assert_allclose(port_losses, jax_losses, **LOSS)
    want = ndt1_state_dict_from_jax(jax.device_get(jt.state.params))
    got = pt.model.state_dict()
    assert set(got) == set(want)
    # the attention key biases' gradient is 0 in exact arithmetic and
    # rounding noise in float: held to what Adam can move them (W.NOISE_ONLY)
    W.assert_states_close(got, want, "120 steps", lr=jcfg["optimizer"]["lr"], steps=STEPS,
                          **PARAMS)
