"""The ``from_pt`` chain of PatchTST in the port's own format, held against
the JAX package's, on the CPU (the helpers and tolerances of
``test_torch_port_warm_start.py``): each package pretrains ``mlm`` 2 steps
from the same weights and running averages, saves and fine-tunes ``ctc`` with
``model.encoder.from_pt``. BatchNorm's running averages are carried in
``encoder.pt``, the carried encoder tensors equal the saved ones bit for bit,
the re-merged encoder config equals the JAX one, and the fine-tune's first two
losses agree with the JAX trainer's at rtol 1e-4. Both packages' patch
masking is fed one fixed noise array of each shape (the re-merged encoder
config keeps ``do_mask_input`` in the fine-tune, as in the JAX package).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
from llm_bci_tpu_torch.interop import patchtst_state_dict_from_jax
from llm_bci_tpu_torch.models import patchtst as tpt

from test_torch_port_warm_start import assert_carried, fine_tune_both, plain, pretrain_both


# ---------------------------------------------------------------------------
# PatchTST mlm -> ctc, BatchNorm's running averages carried
# ---------------------------------------------------------------------------

PT_T, PT_C = 24, 4


def fixed_uniform(shape):
    return np.random.default_rng(int(np.prod(shape))).uniform(size=shape).astype(np.float32)


@pytest.fixture
def fixed_patch_noise(monkeypatch):
    """Both packages' patch-masking noise from ``fixed_uniform`` of its shape
    (the JAX package draws it with ``jax.random.uniform``; nothing else of
    the runs below draws from it: dropout is off)."""
    def patch(jax_too):
        if jax_too:
            monkeypatch.setattr(jax.random, "uniform",
                                lambda key, shape, *a, **k: jnp.asarray(fixed_uniform(shape)))
        monkeypatch.setattr(tpt, "patch_noise", lambda shape, consistent, generator, device:
                            torch.from_numpy(fixed_uniform(
                                (shape[0], 1 if consistent else shape[1], shape[2]))
                            ).expand(*shape))

    return patch


def pt_rows(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        S = int(rng.integers(2, 4))
        out.append({"spikes": rng.poisson(1.0, size=(PT_T, PT_C)).astype(np.float32),
                    "phonemes_idx": rng.integers(1, 7, size=S),
                    "phonemes": ["P"] * S, "sentence": "s"})
    return out


def pt_config(method):
    pad = lambda: {"dim": 0, "side": "left", "value": 0, "truncate": PT_T, "min_length": PT_T}
    pads = {k: pad() for k in ("spikes", "spikes_mask", "spikes_timestamp")}
    if method == "ctc":
        pads["targets"] = {"dim": 0, "side": "right", "value": 0, "truncate": None,
                           "min_length": None}
    return {
        "seed": 4, "savestring": "pt", "verbosity": 3,
        "training": {"num_epochs": 1, "train_batch_size": 4, "test_batch_size": 4,
                     "save_on_preemption": False},
        "parallelism": {"data": 1, "fsdp": -1},
        "precision": {"compute_dtype": "float32"},
        "model": {
            "model_class": "PatchTST",
            "encoder": {"num_input_channels": PT_C, "context_length": PT_T, "patch_length": 4,
                        "patch_stride": 4, "num_hidden_layers": 2, "d_model": 16,
                        "num_attention_heads": 2, "ffn_dim": 32, "norm_type": "batchnorm",
                        "attention_dropout": 0.0, "ff_dropout": 0.0, "positional_dropout": 0.0,
                        "path_dropout": 0.0, "do_mask_input": True, "random_mask_ratio": 0.4},
            "decoder": {"head_dropout": 0.0},
        },
        "data": {"dataset_class": "base" if method == "mlm" else "decoding"},
        "method": {"model_kwargs": {"method_name": method, "loss": "poisson_nll",
                                    "log_input": True, "vocab_size": 7},
                   "dataset_kwargs": {} if method == "mlm" else {"targets_name": "phonemes_idx"},
                   "dataloader_kwargs": {"pad_dict": pads}, "metric_kwargs": {}},
        "optimizer": {"lr": 1e-3, "wd": 0.01, "scheduler": "cosine", "warmup_pct": 0.15},
    }


def pt_head(params):
    sd = patchtst_state_dict_from_jax({"params": params})
    return {k: v for k, v in sd.items() if k.startswith("decoder.")}


def test_patchtst_mlm_to_ctc_chain_matches_jax(tmp_path, fixed_patch_noise):
    fixed_patch_noise(jax_too=False)
    data = {"train": pt_rows(8, 0), "test": pt_rows(4, 1)}
    jt_vars = lambda jt: {"params": jt.state.params, **jt.state.extra_vars}
    # the JAX trainer jits its step when it first runs: the noise is patched
    # for it after its init drew the weights
    real_init = JaxTrainer.__init__

    def init_then_patch(self, *a, **k):
        real_init(self, *a, **k)
        fixed_patch_noise(jax_too=True)

    JaxTrainer.__init__ = init_then_patch
    try:
        jax_step, port_step, pre = pretrain_both(tmp_path, pt_config("mlm"), data,
                                                 patchtst_state_dict_from_jax, jt_vars)
    finally:
        JaxTrainer.__init__ = real_init
    saved = torch.load(os.path.join(port_step, "encoder.pt"), weights_only=True)
    stats = {k: v for k, v in saved.items() if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 8         # 2 layers x 2 norms x (mean, var)
    for k, v in stats.items():
        assert torch.equal(v, pre.model.state_dict()["encoder." + k])
        assert not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))

    JaxTrainer.__init__ = init_then_patch
    try:
        jt, pt, warm, jlog, plog, _ = fine_tune_both(tmp_path, pt_config("ctc"), data, jax_step,
                                                  port_step, pt_head)
    finally:
        JaxTrainer.__init__ = real_init
    assert_carried(warm, port_step)    # the running averages among the carried tensors
    assert plain(pt.model.config["encoder"]) == plain(jt.model.config["encoder"])
    np.testing.assert_allclose(plog, jlog, rtol=1e-4)
