"""Component checkpoints and ``from_pt`` warm start in the port's own format,
held against the JAX package's, on the CPU.

* The repair: a ``from_pt`` directory holding a component's weights without
  its saved config is refused with ``FileNotFoundError``, as the JAX
  package refuses one;
* the pretrain -> fine-tune chains: each package pretrains 2 steps from the
  same weights and saves in its own format (``encoder.pt`` / ``decoder.pt`` /
  ``*_config.yaml`` here, msgpack there), then fine-tunes with
  ``model.encoder.from_pt``. The carried encoder tensors equal the saved
  ones bit for bit, the re-merged encoder config equals the JAX one, and,
  with the fine-tune's fresh head carried across, the fine-tune's first two
  losses agree with the JAX trainer's at rtol 1e-4 (the tolerance of
  ``tests/test_torch_port_trainer.py``: float32 sums in another order over
  the pretraining updates). NDT1 mlm -> ctc here (and -> ``endtoend``,
  which gives the port's ``ctc`` losses bit for bit), iTransformer and
  PatchTST in ``test_torch_port_warm_start_{itransformer,patchtst}.py``.
  Maskers are deterministic, dropout is off. The JAX package loads the mlm
  head saved beside the encoder into a ``ctc`` head of another shape and
  fails at its first step (``ScopeParamShapeError``), so its pretraining
  directory loses ``decoder.msgpack`` before the fine-tune; the port keeps
  the fresh head when the saved one has another shape;
* ``llm_bci_tpu_torch.main`` hands ``-k model.encoder.from_pt`` to the model
  and ``method.model_kwargs.load_ndt1_from_pt`` to BCI, and a resumed run
  keeps its restored state over the warm start.
"""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from llm_bci_tpu.config import DictConfig
from llm_bci_tpu.models import bci as jbci
from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models import bci as tbci
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

import test_torch_port_bci as bci_t
from test_torch_port_trainer import (
    mlm_rows,
    mlm_trainer_config,
    port_cfg,
    speechbci_rows,
    trainer_config,
)

IGNORED = ("from_pt", "compute_dtype")


def losses(log):
    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        log.append(float(np.asarray(outputs["loss"])))
        return 0.0

    return {"rec": record}


def plain(cfg):
    """A config section as plain containers without ``from_pt`` and the JAX
    package's ``compute_dtype``."""
    if isinstance(cfg, dict):
        return {k: plain(v) for k, v in cfg.items() if k not in IGNORED}
    return list(map(plain, cfg)) if isinstance(cfg, (list, tuple)) else cfg


def pretrain_both(tmp_path, cfg, dataset, to_port, jax_vars=lambda jt: jt.state.params):
    """Both packages' pretraining, 2 steps from the JAX init; the port's
    trainer saves ``STEP2``, the JAX model's component blobs and configs are
    written to its ``STEP2`` by the model's own ``save_checkpoint`` /
    ``save_config`` (what its trainer writes there, without the Orbax train
    state). Returns the JAX and port ``STEP2`` directories and the port
    trainer."""
    cfg["training"]["max_steps"] = 2
    cfg["training"]["eval_every"] = None
    jcfg = DictConfig(dict(cfg, dirs={"checkpoint_dir": str(tmp_path / "jax"), "log_dir": None},
                           training=dict(cfg["training"], save_every=None)))
    jt = JaxTrainer(jcfg, dataset=dataset)
    state = to_port(jax.device_get(jax_vars(jt)))
    jt.train()
    jax_step = os.path.join(jt.checkpoint_dir, "STEP2")
    os.makedirs(jax_step)
    jt.model.save_checkpoint(jax_step, jax.device_get(jt.state.params))
    jt.model.save_config(jax_step)
    pcfg = port_cfg(dict(cfg, dirs={"checkpoint_dir": str(tmp_path / "port"), "log_dir": None},
                         training=dict(cfg["training"], save_every=2)))
    pt = PortTrainer(pcfg, dataset=dataset, device="cpu")
    pt.model.load_state_dict(state, strict=True)
    pt.train()
    return jax_step, os.path.join(pt.checkpoint_dir, "STEP2"), pt


def fine_tune_both(tmp_path, cfg, dataset, jax_step, port_step, head_to_port,
                   head_beside_encoder=False):
    """Both fine-tunes from their package's ``STEP2`` by
    ``model.encoder.from_pt``; the port takes the JAX fine-tune's fresh head
    (``head_to_port(jax params)``, a state dict) before training. Returns
    (JAX trainer, port trainer, the port model's state before training, both
    loss logs, that head). ``head_beside_encoder``: the port warns that the pretraining
    head beside the encoder is another method's and keeps the fresh one
    (NDT1)."""
    if os.path.exists(os.path.join(jax_step, "decoder.msgpack")):
        os.remove(os.path.join(jax_step, "decoder.msgpack"))
    jlog, plog = [], []
    cfg["training"]["max_steps"] = 2
    cfg["training"]["eval_every"] = cfg["training"]["save_every"] = None
    jcfg = DictConfig(dict(cfg, dirs={"checkpoint_dir": str(tmp_path / "jft"), "log_dir": None}))
    jcfg["model"]["encoder"]["from_pt"] = jax_step
    jt = JaxTrainer(jcfg, dataset=dataset, metric_fns=losses(jlog))
    pcfg = port_cfg(dict(cfg, dirs={"checkpoint_dir": str(tmp_path / "pft"), "log_dir": None}))
    pcfg["model"]["encoder"]["from_pt"] = port_step
    if head_beside_encoder:
        with pytest.warns(UserWarning, match="keeps its fresh init"):
            pt = PortTrainer(pcfg, dataset=dataset, metric_fns=losses(plog), device="cpu")
    else:
        pt = PortTrainer(pcfg, dataset=dataset, metric_fns=losses(plog), device="cpu")
    warm = {k: v.clone() for k, v in pt.model.state_dict().items()}
    head = head_to_port(jax.device_get(jt.state.params))
    pt.model.load_state_dict(head, strict=False)
    jt.train()
    pt.train()
    return jt, pt, warm, jlog, plog, head


def assert_carried(warm, port_step, prefix="encoder."):
    saved = torch.load(os.path.join(port_step, "encoder.pt"), weights_only=True)
    enc = {k[len(prefix):]: v for k, v in warm.items() if k.startswith(prefix)}
    assert set(enc) == set(saved)
    for k, v in saved.items():
        assert torch.equal(enc[k], v), k


# ---------------------------------------------------------------------------
# The repair
# ---------------------------------------------------------------------------


def test_from_pt_dir_without_its_component_config_is_refused(tmp_path):
    port = tmp_path / "port"
    port.mkdir()
    model = tbci.BCI.from_config(PortDictConfig(bci_t.model_config()), compute_dtype="float32",
                                 **bci_t.method_kwargs())
    model.save_checkpoint(str(port))
    model.save_config(str(port))
    # the whole checkpoint reloads; without encoder_config.yaml it is refused
    tbci.BCI.from_config(PortDictConfig({"from_pt": str(port)}), debug=True)
    os.remove(port / "encoder_config.yaml")
    with pytest.raises(FileNotFoundError, match="holds encoder weights but no saved 'encoder'"):
        tbci.BCI.from_config(PortDictConfig({"from_pt": str(port)}), debug=True)
    # the JAX package refuses its own checkpoint with the same file missing
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for name in ("encoder.msgpack", "projector.msgpack", "llm.msgpack"):
        (jdir / name).write_bytes(b"")
    (jdir / "projector_config.yaml").write_text("inter_size: 24\n")
    with pytest.raises(FileNotFoundError, match="holds encoder weights but no saved 'encoder'"):
        jbci.BCI.from_config(DictConfig({"from_pt": str(jdir)}), debug=True)
    # and a reference-format directory likewise (encoder.bin, no .pth)
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "encoder.bin").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="holds encoder weights"):
        tbci.BCI.from_config(PortDictConfig({"from_pt": str(ref)}), debug=True)


# ---------------------------------------------------------------------------
# NDT1 mlm -> ctc / endtoend
# ---------------------------------------------------------------------------


def ndt1_head(params):
    return {"decoder.weight": torch.from_numpy(np.asarray(params["decoder"]["kernel"]).T.copy()),
            "decoder.bias": torch.from_numpy(np.asarray(params["decoder"]["bias"]).copy())}


def test_ndt1_mlm_to_ctc_and_endtoend_chains_match_jax(tmp_path):
    pre = mlm_trainer_config(tmp_path, False)
    jax_step, port_step, _ = pretrain_both(
        tmp_path, pre, {"train": mlm_rows(10, 0), "val": mlm_rows(4, 1)},
        ndt1_state_dict_from_jax)
    assert sorted(os.listdir(port_step)) == ["decoder.pt", "encoder.pt", "encoder_config.yaml",
                                             "optimizer.pt", "trainer_config.yaml"]
    ft = trainer_config(tmp_path)
    data = {"train": speechbci_rows(8, 2), "test": speechbci_rows(4, 3)}
    jt, pt, warm, jlog, plog, head = fine_tune_both(
        tmp_path / "ctc", ft, data, jax_step, port_step, ndt1_head, head_beside_encoder=True)
    assert_carried(warm, port_step)
    assert warm["decoder.weight"].shape == (ft["method"]["model_kwargs"]["vocab_size"], 32)
    # the mlm pretrain's encoder config, stack off, came with the encoder
    enc = pt.model.config["encoder"]
    assert not enc["embedder"]["stack"]["active"] and enc["from_pt"] == port_step
    assert plain(enc) == plain(jt.model.config["encoder"])
    assert len(jlog) == len(plog) == 2
    np.testing.assert_allclose(plog, jlog, rtol=1e-4)

    # endtoend is the ctc head and loss under another name (as in the JAX
    # package, whose two methods run one code path): the same fine-tune
    cfg = port_cfg(dict(ft, dirs={"checkpoint_dir": str(tmp_path / "e2e"), "log_dir": None}))
    cfg["model"]["encoder"]["from_pt"] = port_step
    cfg["method"]["model_kwargs"]["method_name"] = "endtoend"
    elog = []
    with pytest.warns(UserWarning, match="keeps its fresh init"):
        et = PortTrainer(cfg, dataset=data, metric_fns=losses(elog), device="cpu")
    et.model.load_state_dict(head, strict=False)
    et.train()
    assert et.model.method_name == "endtoend" and elog == plog


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_main_hands_from_pt_to_the_model_and_resume_wins(tmp_path):
    import pickle

    from llm_bci_tpu_torch import main as port_main

    with open(tmp_path / "spikes.pkl", "wb") as f:
        pickle.dump({"train": mlm_rows(8, 0), "val": mlm_rows(4, 1)}, f)
    common = ["-c", "configs/trainer_ssl_ndt1.yaml", "--device", "cpu", "-k",
              "data.data_load=file", f"data.data_dir={tmp_path}", "data.data_file=spikes.pkl",
              "training.train_batch_size=4", "training.test_batch_size=4",
              "training.eval_every=null", "training.save_every=2", "training.max_steps=2",
              "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
              "model.encoder.embedder.stack.active=false", "model.encoder.transformer.n_layers=1",
              "model.encoder.transformer.hidden_size=16", "model.encoder.transformer.n_heads=2",
              "model.encoder.transformer.inter_size=16", "verbosity=3"]
    pre = port_main.main(port_main.parse_args(
        common + [f"dirs.checkpoint_dir={tmp_path / 'pre'}", "dirs.log_dir=null"]))
    step = os.path.join(pre.checkpoint_dir, "STEP2")
    # a fine-tune's CLI: -k model.encoder.from_pt=<STEP dir>; its live
    # widths differ and the saved config wins
    ft = port_main.build_trainer(port_main.parse_args(
        common + [f"dirs.checkpoint_dir={tmp_path / 'ft'}", "dirs.log_dir=null",
                  f"model.encoder.from_pt={step}", "model.encoder.transformer.hidden_size=32"]))
    assert ft.model.config["encoder"]["from_pt"] == step
    assert ft.model.config["encoder"]["transformer"]["hidden_size"] == 16
    assert_carried(ft.model.state_dict(), step)

    # resume: the restored train state, not the warm start, is what trains on
    ft.train()
    trained = {k: v.clone() for k, v in ft.model.state_dict().items()}
    resumed = port_main.main(port_main.parse_args(
        common + [f"dirs.checkpoint_dir={tmp_path / 'ft'}", "dirs.log_dir=null",
                  f"model.encoder.from_pt={step}", "training.resume=true",
                  "training.max_steps=2"]))
    for k, v in trained.items():
        assert torch.equal(resumed.model.state_dict()[k], v), k

    # BCI: method.model_kwargs.load_ndt1_from_pt reaches the model and reads
    # the NDT1 trainer's encoder.pt
    cfg = bci_t.model_config()
    with open(os.path.join(step, "encoder_config.yaml")) as f:
        cfg["ndt1"]["encoder"] = yaml.safe_load(f)
    model = tbci.BCI.from_config(PortDictConfig(cfg), compute_dtype="float32",
                                 **bci_t.method_kwargs(load_ndt1_from_pt=step))
    model.warm_start()
    assert_carried({"encoder." + k: v for k, v in model.ndt1_encoder.state_dict().items()}, step)
