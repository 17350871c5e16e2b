"""Reference-format checkpoints of NDT1 and iTransformer: the port against
the JAX package's own importer and exporter, on the CPU (PatchTST and
``interop/safetensors.py`` in ``test_torch_port_interop_patchtst.py``, BCI in
``test_torch_port_interop_bci.py``).

* JAX exporter -> port importer: ``llm_bci_tpu/interop/torch_export.py``
  writes a reference-format directory from seeded JAX weights; the port
  builds the model with ``from_pt`` on it (the saved configs re-merged) and
  its eval forward matches the JAX model's, atol 1e-5 / rtol 1e-4 (float32
  sums in another order);
* port exporter -> JAX importer: the port, loaded with the same weights,
  exports; ``llm_bci_tpu/interop/torch_import.py`` reads the files into a
  JAX tree that equals the original bit for bit;
* the strict import raises with the JAX package's messages.
"""
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.interop import torch_export as jexport
from llm_bci_tpu.interop import torch_import as jimport
from llm_bci_tpu.models import itransformer as jitr
from llm_bci_tpu.models import ndt1 as jndt1
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.interop import (
    itransformer_state_dict_from_jax,
    ndt1_state_dict_from_jax,
)
from llm_bci_tpu_torch.interop import torch_export as texport
from llm_bci_tpu_torch.interop import torch_import as timport
from llm_bci_tpu_torch.models import itransformer as tit
from llm_bci_tpu_torch.models import ndt1 as tndt1

import test_torch_port_itransformer as itr_t
import test_torch_port_ndt1 as ndt1_t
from test_torch_port_itransformer import random_variables, tt

FWD = dict(atol=1e-5, rtol=1e-4)


def assert_trees_equal(a, b, path=""):
    """Two nested dicts of arrays with the same keys and the same bits."""
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


def with_from_pt(cfg, path, components=("encoder", "decoder")):
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in cfg.items()}
    for comp in components:
        cfg.setdefault(comp, {})["from_pt"] = path
    return PortDictConfig(cfg)


# ---------------------------------------------------------------------------
# NDT1
# ---------------------------------------------------------------------------

NDT1_CASES = {
    "stacked": {},
    "per_day_tokens_factors": {"adapt": True, "day_token": True, "block_token": True,
                               "stack": {"active": False}},
}


def ndt1_pair(case, tmp_path):
    cfg = ndt1_t.model_config(**NDT1_CASES[case])
    if case != "stacked":
        cfg["encoder"]["factors"] = {"active": True, "size": 16}
    kw = dict(method_name="ctc", vocab_size=ndt1_t.V, blank_id=0, zero_infinity=True)
    jmodel = jndt1.NDT1.from_config(cfg, compute_dtype="float32", **kw)
    batch = ndt1_t.make_batch()
    init = types.SimpleNamespace(init=functools.partial(jmodel.init, training=False))
    params = random_variables(init, 0, **{k: jnp.asarray(v) for k, v in batch.items()})["params"]
    return cfg, kw, jmodel, params, batch


@pytest.mark.parametrize("case", sorted(NDT1_CASES))
def test_ndt1_reference_checkpoint_both_ways(case, tmp_path):
    cfg, kw, jmodel, params, batch = ndt1_pair(case, tmp_path)
    jout = jmodel.apply({"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()},
                        training=False)
    ref = str(tmp_path / "jax_ref")
    jexport.ndt1_save_reference_checkpoint(params, jmodel.config, ref)
    # the port builds from the saved encoder_config.pth (the live config
    # below has another width) and imports encoder.bin and decoder.bin
    live = ndt1_t.model_config()
    live["encoder"]["transformer"]["hidden_size"] = 64
    tmodel = tndt1.NDT1.from_config(with_from_pt(live, ref, ("encoder",)), **kw)
    assert tmodel.config["encoder"]["from_pt"] == ref
    tmodel.warm_start()
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(**tt(batch))
    np.testing.assert_allclose(tout.preds.numpy(), np.asarray(jout.preds), **FWD)
    np.testing.assert_allclose(tout.loss.item(), float(jout.loss), rtol=1e-4)

    # the other direction: the port's export read by the JAX importer
    port = tndt1.NDT1.from_config(cfg, **kw)
    port.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)
    out = str(tmp_path / "port_ref")
    texport.ndt1_save_reference_checkpoint(port, out)
    back = jimport.ndt1_params_from_torch(out, jax.tree_util.tree_map(np.zeros_like, params))
    assert_trees_equal(back, params)
    saved = torch.load(os.path.join(out, "encoder_config.pth"), weights_only=True)
    assert "from_pt" not in saved and "flash_attention" not in saved["transformer"]


def test_ndt1_strict_import_messages(tmp_path):
    cfg, kw, jmodel, params, _ = ndt1_pair("stacked", tmp_path)
    ref = str(tmp_path / "ref")
    jexport.ndt1_save_reference_checkpoint(params, jmodel.config, ref)
    path = os.path.join(ref, "encoder.bin")
    good = torch.load(path, weights_only=True)
    model = tndt1.NDT1.from_config(cfg, **kw)

    def load_with(sd):
        torch.save(sd, path)
        return timport.ndt1_state_dict_from_reference(ref, model)

    with pytest.raises(ValueError, match="were not imported: \\['mystery.weight'\\].*refusing"):
        load_with({**good, "mystery.weight": torch.zeros(1)})
    bad = dict(good)
    bad["out_norm.weight"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape mismatch for 'encoder.out_norm.weight'"):
        load_with(bad)
    deeper = dict(good)
    deeper.update({k.replace("layers.1.", "layers.2."): v for k, v in good.items()
                   if k.startswith("layers.1.")})
    with pytest.raises(ValueError, match="checkpoint has ≥3 transformer layers, model has 2"):
        load_with(deeper)
    missing = {k: v for k, v in good.items() if k != "out_norm.bias"}
    with pytest.raises(KeyError, match="missing key 'out_norm.bias'"):
        load_with(missing)
    # the same files are refused by the JAX importer, with the same words
    torch.save({**good, "mystery.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="were not imported: \\['mystery.weight'\\].*refusing"):
        jimport.ndt1_params_from_torch(ref, params)


# ---------------------------------------------------------------------------
# iTransformer: both embedder modes, CLS on and off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_cls", [True, False], ids=["cls", "no_cls"])
@pytest.mark.parametrize("mode", ["mlp", "transformer"])
def test_itransformer_reference_checkpoint_both_ways(mode, use_cls, tmp_path):
    head = "ctc"
    cfg = itr_t.model_config(head, mode)
    cfg["decoder"]["use_cls"] = use_cls
    kw = dict(method_name=head, **itr_t.head_kwargs(head))
    jmodel = jitr.iTransformer.from_config(cfg, compute_dtype="float32", **kw)
    batch = itr_t.make_batch(head)
    params = random_variables(jmodel, 0, **{k: jnp.asarray(v) for k, v in batch.items()})
    params = params["params"]
    jout = itr_t.jrun(jmodel, params, batch, training=False)
    ref = str(tmp_path / "jax_ref")
    jexport.itransformer_save_reference_checkpoint(params, jmodel.config, ref, method_name=head)
    # encoder and decoder each from their own from_pt (one directory here)
    tmodel = tit.iTransformer.from_config(with_from_pt(cfg, ref), **kw)
    tmodel.warm_start()
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(**tt(batch))
    np.testing.assert_allclose(tout.preds.numpy(), np.asarray(jout.preds), **FWD)

    port = tit.iTransformer.from_config(cfg, **kw)
    port.load_state_dict(itransformer_state_dict_from_jax(params), strict=True)
    out = str(tmp_path / "port_ref")
    texport.itransformer_save_reference_checkpoint(port, out)
    back = jimport.itransformer_params_from_torch(
        out, jax.tree_util.tree_map(np.zeros_like, params))
    assert_trees_equal(back, params)


def test_itransformer_strict_import_messages(tmp_path):
    cfg = itr_t.model_config("ctc", "mlp")
    kw = dict(method_name="ctc", **itr_t.head_kwargs("ctc"))
    port = tit.iTransformer.from_config(cfg, **kw)
    ref = str(tmp_path / "ref")
    texport.itransformer_save_reference_checkpoint(port, ref)
    enc = torch.load(os.path.join(ref, "encoder.bin"), weights_only=True)
    deeper = {**enc, **{k.replace("layers.1.", "layers.2."): v for k, v in enc.items()
                        if k.startswith("transformer.layers.1.")}}
    torch.save(deeper, os.path.join(ref, "encoder.bin"))
    with pytest.raises(ValueError, match="iTransformer encoder: checkpoint has ≥3 layers, "
                                         "model has 2"):
        timport.itransformer_state_dict_from_reference(ref, port)
    # a decoder with a hidden layer into a model without one
    cfg["decoder"]["mlp_decoder"] = False
    slim = tit.iTransformer.from_config(cfg, **kw)
    with pytest.raises(ValueError, match="decoder has 2 linears but model lacks a hidden layer"):
        timport.itransformer_state_dict_from_reference(ref, slim, ("decoder",))
