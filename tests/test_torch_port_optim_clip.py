"""``optimizer.grad_clip_norm``: the port's clipped AdamW against ``optax``.

* ``training/optim.py::clip_by_global_norm`` + ``torch.optim.AdamW`` against
  the JAX package's ``build_optimizer`` (``optax.chain(clip_by_global_norm,
  adamw)``, inside ``optax.MultiSteps`` under accumulation) wrapped in the JAX
  trainer's ``multi_transform({"train": tx, "freeze": set_to_zero()})``: the
  global norm is 50 and the clip 1, a frozen leaf with a large gradient sits
  beside the trainable ones and must not enter the norm; with
  ``gradient_accumulation_steps=2`` the clip applies to the average of the
  two micro-batch gradients. The clipped gradients' norm rtol 1e-6;
  parameters after each update rtol 1e-6 with atol 3e-7, two float32 ulps of
  the parameters' scale of 1 (the plain AdamW update is off by that much
  from optax's where the moments nearly cancel).
* The port's ``Trainer`` (NDT1-CTC, and BCI with a frozen LoRA base) with
  ``gradient_accumulation_steps: 2``: the gradients that reach AdamW equal
  the average of the two micro-batches' gradients, computed apart, scaled by
  ``clip / norm`` (rtol 1e-6, atol 1e-9), ``Trainer.grad_norm`` is that
  norm over the trainable parameters, and frozen leaves hold no gradient.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_bci_tpu.config import DictConfig
from llm_bci_tpu.training.optim import build_optimizer as jax_build_optimizer
from llm_bci_tpu_torch.training import optim
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests.test_torch_port_trainer import port_cfg, speechbci_rows, trainer_config


@pytest.mark.parametrize("gas", [1, 2])
def test_clipped_adamw_matches_optax(gas):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (3,), "frozen": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = DictConfig({"lr": 1e-2, "wd": 0.05, "eps": 1e-8, "scheduler": "linear",
                      "grad_clip_norm": 1.0, "gradient_accumulation_steps": gas})
    tx, _ = jax_build_optimizer(cfg, steps_per_epoch=3 * gas, num_epochs=1)
    tx = optax.multi_transform({"train": tx, "freeze": optax.set_to_zero()},
                               {"w": "train", "b": "train", "frozen": "freeze"})
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)

    trainable = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("w", "b")]
    opt, schedule = optim.build_optimizer(trainable, port_cfg(cfg), steps_per_epoch=3 * gas,
                                          num_epochs=1)
    for update in range(3):
        for micro in range(gas):
            g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            scale = 50.0 / np.sqrt(sum(float((g[k] ** 2).sum()) for k in ("w", "b")))
            g = {k: (v * scale * (1 + micro)).astype(np.float32) for k, v in g.items()}
            g["frozen"] *= 1e3
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
            params = optax.apply_updates(params, updates)
            # the trainer's backward of loss / gas, summed into .grad
            for p, k in zip(trainable, ("w", "b")):
                gk = torch.from_numpy(g[k]) / gas
                p.grad = gk if p.grad is None else p.grad + gk
        avg = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in trainable))
        norm = optim.clip_by_global_norm(trainable, 1.0)
        np.testing.assert_allclose(float(norm), avg, rtol=1e-6)
        assert float(norm) > 40
        np.testing.assert_allclose(
            np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in trainable)), 1.0, rtol=1e-6)
        opt.param_groups[0]["lr"] = schedule(update)
        opt.step()
        opt.zero_grad(set_to_none=True)
        for p, k in zip(trainable, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=3e-7, err_msg=f"{k} update {update}")
        np.testing.assert_array_equal(np.asarray(params["frozen"]), p0["frozen"])


def ndt1_trainer(tmp_path, clip):
    cfg = trainer_config(tmp_path)
    cfg["optimizer"].update({"grad_clip_norm": clip, "gradient_accumulation_steps": 2})
    dataset = {"train": speechbci_rows(10, 0), "test": speechbci_rows(4, 1)}
    return PortTrainer(port_cfg(cfg), dataset=dataset, device="cpu")


def bci_trainer(tmp_path, clip):
    from tests.test_bci import synth_bci_dataset
    from tests.test_torch_port_bci import trainer_config as bci_config

    cfg = bci_config(tmp_path)
    cfg["optimizer"].update({"grad_clip_norm": clip, "gradient_accumulation_steps": 2})
    return PortTrainer(port_cfg(cfg), dataset=synth_bci_dataset(n_train=8, n_test=4),
                       device="cpu")


@pytest.mark.parametrize("build", [ndt1_trainer, bci_trainer], ids=["ndt1", "bci_frozen_base"])
def test_trainer_clips_the_averaged_gradient(tmp_path, build):
    clip = 1e-2
    trainer = build(tmp_path, clip)
    batches = iter(trainer.train_dataloader)
    b1, b2 = (trainer.to_device(next(batches)[0]) for _ in range(2))
    frozen = [p for p in trainer.model.parameters() if not p.requires_grad]
    assert (len(frozen) > 0) == (build is bci_trainer)

    # the reference: each micro-batch's gradient apart, averaged, then clipped
    ref = copy.deepcopy(trainer.model).train()
    grads = []
    for b in (b1, b2):
        ref.zero_grad(set_to_none=True)
        ref(**b, generator=torch.Generator().manual_seed(0)).loss.backward()
        grads.append([p.grad.clone() for p in ref.parameters() if p.requires_grad])
    avg = [(a / 2 + b / 2) for a, b in zip(*grads)]
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in avg]))
    assert float(norm) > 10 * clip

    seen = []
    trainer.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: seen.append([p.grad.clone() for p in trainer.trainable]))
    trainer.train_step(b1)
    assert not seen and trainer.grad_norm is None          # inside the window: no update
    trainer.train_step(b2)
    (got,) = seen
    np.testing.assert_allclose(float(trainer.grad_norm), float(norm), rtol=1e-6)
    for g, want in zip(got, avg):
        np.testing.assert_allclose(g.numpy(), (want / norm * clip).numpy(), rtol=1e-6, atol=1e-9)
    assert all(p.grad is None for p in frozen)
