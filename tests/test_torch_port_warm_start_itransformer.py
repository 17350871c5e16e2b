"""The ``from_pt`` chain of iTransformer in the port's own format, held against the JAX package's, on the CPU (the helpers and tolerances of
``test_torch_port_warm_start.py``): each package pretrains 2 steps from the
same weights, saves and fine-tunes with ``model.encoder.from_pt``; the
carried encoder tensors equal the saved ones bit for bit, the re-merged
encoder config equals the JAX one, and the fine-tune's first two losses
agree with the JAX trainer's at rtol 1e-4:
ssl -> choice (a deterministic ``co-smooth`` masker in the pretraining),
then a second fine-tune with the encoder from the ssl run and the decoder
from the choice run by ``decoder.from_pt``. PatchTST's chain is in
``test_torch_port_warm_start_patchtst.py``.
"""
import os

import numpy as np
import torch

from llm_bci_tpu_torch.interop import itransformer_state_dict_from_jax
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from test_torch_port_trainer import port_cfg
from test_torch_port_warm_start import assert_carried, fine_tune_both, plain, pretrain_both


# ---------------------------------------------------------------------------
# iTransformer ssl -> choice
# ---------------------------------------------------------------------------

ITR_T, ITR_N = 12, 6


def itr_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"spikes": rng.poisson(1.0, size=(ITR_T, ITR_N)).astype(np.float32),
             "choice": np.atleast_1d(int(rng.integers(0, 2)))} for _ in range(n)]


def itr_config(tmp_path, method):
    pad = lambda: {"dim": 0, "side": "left", "value": 0, "truncate": ITR_T, "min_length": ITR_T}
    masker = ({"active": True, "force_active": True, "mode": "co-smooth", "channels": [1, 4],
               "zero_ratio": 1.0} if method == "mlm" else {"active": False})
    kwargs = ({"loss": "poisson_nll", "log_input": True} if method == "mlm"
              else {"loss": "xent", "n_labels": 2})
    return {
        "seed": 2, "savestring": "itr", "verbosity": 3,
        "training": {"num_epochs": 1, "train_batch_size": 4, "test_batch_size": 4,
                     "save_on_preemption": False},
        "parallelism": {"data": 1, "fsdp": -1},
        "precision": {"compute_dtype": "float32"},
        "model": {
            "model_class": "iTransformer", "masker": {"main": masker},
            "encoder": {"embedder": {"mode": "mlp", "max_n_bins": ITR_T, "dropout": 0.0},
                        "hidden_size": 16, "n_heads": 2, "n_layers": 2, "dropout": 0.0,
                        "max_n_channels": 8, "embed_region": False, "embed_depth": False},
            "decoder": {"mlp_decoder": True, "use_cls": True},
        },
        "data": {"dataset_class": "base" if method == "mlm" else "decoding"},
        "method": {"model_kwargs": {"method_name": method, **kwargs},
                   "dataset_kwargs": {} if method == "mlm" else {"targets_name": "choice"},
                   "dataloader_kwargs": {"pad_dict": {
                       k: pad() for k in ("spikes", "spikes_mask", "spikes_timestamp")}},
                   "metric_kwargs": {}},
        "optimizer": {"lr": 1e-3, "wd": 0.01, "scheduler": "cosine", "warmup_pct": 0.15},
    }


def itr_head(params):
    sd = itransformer_state_dict_from_jax(params)
    return {k: v for k, v in sd.items() if not k.startswith("encoder.")}


def test_itransformer_ssl_to_choice_chain_matches_jax(tmp_path):
    data = {"train": itr_rows(8, 0), "test": itr_rows(4, 1)}
    jax_step, port_step, _ = pretrain_both(tmp_path, itr_config(tmp_path, "mlm"), data,
                                           itransformer_state_dict_from_jax)
    assert {"encoder.pt", "decoder.pt", "encoder_config.yaml",
            "decoder_config.yaml"} <= set(os.listdir(port_step))
    jt, pt, warm, jlog, plog, _ = fine_tune_both(tmp_path, itr_config(tmp_path, "stat_behaviour"),
                                              data, jax_step, port_step, itr_head)
    assert_carried(warm, port_step)
    assert plain(pt.model.config["encoder"]) == plain(jt.model.config["encoder"])
    np.testing.assert_allclose(plog, jlog, rtol=1e-4)

    # the decoder by its own from_pt: the choice run's head, the ssl encoder
    choice_step = str(tmp_path / "choice")
    os.makedirs(choice_step)
    pt.model.save_checkpoint(choice_step)
    pt.model.save_config(choice_step)
    cfg = port_cfg(dict(itr_config(tmp_path, "stat_behaviour"),
                        dirs={"checkpoint_dir": str(tmp_path / "both"), "log_dir": None}))
    cfg["model"]["encoder"]["from_pt"] = port_step
    cfg["model"]["decoder"]["from_pt"] = choice_step
    both = PortTrainer(cfg, dataset=data, device="cpu").model.state_dict()
    assert_carried(both, port_step)
    head = torch.load(os.path.join(choice_step, "decoder.pt"), weights_only=True)
    assert set(head) == {"decoder_hidden.weight", "decoder_hidden.bias", "decoder_out.weight",
                         "decoder_out.bias"}
    for k, v in head.items():
        assert torch.equal(both[k], v), k
