"""Reference-format checkpoints of PatchTST (BatchNorm with its running
statistics, and LayerNorm; shared and per-channel heads), and
``interop/safetensors.py``, on the CPU, with the tolerances of
``test_torch_port_interop.py``:

* JAX exporter -> port importer: the eval forward of the port built by
  ``from_pt`` matches the JAX model's, atol 1e-5 / rtol 1e-4, and its
  running statistics equal the exported ones bit for bit;
* port exporter -> JAX importer: params and ``batch_stats`` bit-equal, the
  ``num_batches_tracked`` int64 scalars and the sincos ``position_enc`` in
  ``encoder.bin``; a trained (not sincos) position table is refused;
* ``interop/safetensors.py`` against the ``safetensors`` package for F32,
  F16, BF16 and I8 with ``__metadata__``, both ways.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.interop import torch_export as jexport
from llm_bci_tpu.interop import torch_import as jimport
from llm_bci_tpu_torch.interop import patchtst_state_dict_from_jax
from llm_bci_tpu_torch.interop import safetensors as tsafe
from llm_bci_tpu_torch.interop import torch_export as texport
from llm_bci_tpu_torch.interop import torch_import as timport
from llm_bci_tpu_torch.models import patchtst as tpt

import test_torch_port_patchtst as pt_t
from test_torch_port_interop import FWD, assert_trees_equal, with_from_pt
from test_torch_port_itransformer import tt


# ---------------------------------------------------------------------------
# PatchTST: BatchNorm (running statistics) and LayerNorm, shared and
# per-channel heads
# ---------------------------------------------------------------------------

PATCHTST_CASES = [("mlm", "batchnorm", True, True), ("mlm", "layernorm", False, True),
                  ("ctc", "batchnorm", False, False)]


@pytest.mark.parametrize("method,norm,share,mlp", PATCHTST_CASES)
def test_patchtst_reference_checkpoint_both_ways(method, norm, share, mlp, tmp_path):
    cfg = pt_t.model_config(norm=norm, share=share, mlp_decoder=mlp)
    jmodel, variables, _, batch = pt_t.build_pair(cfg, method)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jmodel.apply(variables, **jb, training=False)
    ref = str(tmp_path / "jax_ref")
    jexport.patchtst_save_reference_checkpoint(variables, jmodel.config, ref)
    kw = dict(method_name=method, vocab_size=pt_t.V, loss="poisson_nll", log_input=True)
    tmodel = tpt.PatchTSTForSpikingActivity.from_config(with_from_pt(cfg, ref), **kw)
    tmodel.warm_start()
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(**tt(batch))
    np.testing.assert_allclose(tout.preds.numpy(), np.asarray(jout.preds), **FWD)
    if norm == "batchnorm":
        stats = variables["batch_stats"]["encoder"]
        for i in range(2):
            for ours in ("norm1", "norm2"):
                bn = getattr(tmodel.encoder.layers[i], ours).bn
                np.testing.assert_array_equal(bn.running_mean.numpy(),
                                              stats[f"layer_{i}"][ours]["bn"]["mean"])
                np.testing.assert_array_equal(bn.running_var.numpy(),
                                              stats[f"layer_{i}"][ours]["bn"]["var"])

    port = tpt.PatchTSTForSpikingActivity.from_config(cfg, **kw)
    port.load_state_dict(patchtst_state_dict_from_jax(variables), strict=True)
    out = str(tmp_path / "port_ref")
    texport.patchtst_save_reference_checkpoint(port, out)
    enc = torch.load(os.path.join(out, "encoder.bin"), weights_only=True)
    tracked = [k for k in enc if k.endswith("num_batches_tracked")]
    assert len(tracked) == (4 if norm == "batchnorm" else 0)
    assert all(enc[k].dtype == torch.int64 for k in tracked)
    assert "encoder.positional_encoder.position_enc" in enc
    back = jimport.patchtst_variables_from_torch(
        out, jax.tree_util.tree_map(np.zeros_like, variables))
    assert_trees_equal(back, variables)


def test_patchtst_position_table_must_be_the_sincos_one(tmp_path):
    cfg = pt_t.model_config()
    kw = dict(method_name="mlm", loss="poisson_nll", log_input=True)
    port = tpt.PatchTSTForSpikingActivity.from_config(cfg, **kw)
    ref = str(tmp_path / "ref")
    texport.patchtst_save_reference_checkpoint(port, ref)
    path = os.path.join(ref, "encoder.bin")
    enc = torch.load(path, weights_only=True)
    enc["encoder.positional_encoder.position_enc"] += 0.01
    torch.save(enc, path)
    with pytest.raises(ValueError, match="positional encoding differs from the sincos table"):
        timport.patchtst_state_dict_from_reference(ref, port)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int8],
                         ids=["F32", "F16", "BF16", "I8"])
def test_safetensors_round_trip_against_the_package(dtype, tmp_path):
    import safetensors.torch as st

    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": (torch.randn(5, 3, generator=g) * 50).to(dtype),
        "b": (torch.randn(7, generator=g) * 50).to(dtype),
        "scalar": torch.tensor(3, dtype=dtype),
        "empty": torch.zeros(0, 4, dtype=dtype),
    }
    meta = {"format": "pt", "note": "seeded"}
    ours = str(tmp_path / "ours.safetensors")
    theirs = str(tmp_path / "theirs.safetensors")
    tsafe.save_file(tensors, ours, metadata=meta)
    st.save_file(tensors, theirs, metadata=meta)
    for path in (ours, theirs):
        for loaded in (st.load_file(path), tsafe.load_file(path)):
            assert set(loaded) == set(tensors)
            for k, v in tensors.items():
                assert loaded[k].dtype == dtype and torch.equal(loaded[k], v), (path, k)
        assert tsafe.load_metadata(path) == meta
    with st.safe_open(ours, "pt") as f:
        assert f.metadata() == meta
    if dtype == torch.float32:
        import safetensors.numpy as snp

        back = snp.load_file(ours)
        np.testing.assert_array_equal(back["a.weight"], tensors["a.weight"].numpy())
