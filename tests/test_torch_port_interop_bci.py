"""Reference-format BCI checkpoints: the port against the JAX package's own
importer and exporter, on the CPU, at the debug Llama size with LoRA ``B``
non-zero, float32.

* JAX exporter -> port importer: ``bci_save_reference_checkpoint`` with
  ``save_hf_llama`` and ``save_peft_adapter`` writes the inner NDT1's
  ``encoder.bin``, ``projector.bin``, the HF base and the PEFT adapter; the
  port builds the BCI with ``from_pt`` on that directory and its logits match
  the JAX model's, atol 1e-5 / rtol 1e-4; an int8 port BCI from the same
  files holds the codes and scales of the JAX importer's int8 tree bit for
  bit;
* port exporter -> JAX importer: the JAX tree read back equals the original
  bit for bit (the JAX importer loads the HF base with ``transformers``, from
  a directory of its own: ``transformers`` takes a directory with
  ``adapter_config.json`` for an adapter);
* the PEFT adapter's config is validated, a single-Linear projector does not
  go into a two-layer one, and a directory with neither base nor adapter
  raises, all with the JAX package's messages;
* ``eval_phonemes.main`` on a reference-format directory with its
  torch-pickled ``trainer_config.pth``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import DictConfig, to_plain_dict
from llm_bci_tpu.interop import torch_export as jexport
from llm_bci_tpu.interop import torch_import as jimport
from llm_bci_tpu.models import bci as jbci
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.interop import bci_state_dict_from_jax
from llm_bci_tpu_torch.interop import torch_export as texport
from llm_bci_tpu_torch.models import bci as tbci

from test_torch_port_bci import (
    FWD,
    LORA,
    make_batch,
    method_kwargs,
    model_config,
    tensors,
    trainer_config,
)
from test_torch_port_eval_phonemes import WordTokenizer
from tests.test_bci import synth_bci_dataset


@pytest.fixture(scope="module")
def pair():
    """(JAX BCI in float32, seeded params in the shapes of its ``init``
    (every leaf drawn, LoRA ``B`` non-zero), the port's BCI with them, a
    batch); ``test_torch_port_bci.build_pair`` without the compile of
    ``init``."""
    jm = jbci.BCI.from_config(DictConfig(model_config()), **method_kwargs()).clone(
        dtype=jnp.float32)
    batch = make_batch()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            **{k: jnp.asarray(v) for k, v in batch.items()})["params"]
    rng = np.random.default_rng(0)

    def draw(path, x):
        # the scale of init: norms near 1, weights normal(0, 0.02), LoRA B
        # non-zero as after training
        name = str(path[-1].key)
        norm = name == "scale" or any("norm" in str(p.key) for p in path)
        std = 0.05 if name == "lora_B" else 0.02
        return (rng.normal(size=x.shape) * std + norm).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tm = tbci.BCI.from_config(PortDictConfig(model_config()), compute_dtype="float32",
                              **method_kwargs())
    tm.load_state_dict(bci_state_dict_from_jax(params), strict=True)
    return jm, params, tm, batch


def jax_reference_dir(pair, root, include_base=True):
    jm, params, _, _ = pair
    jexport.bci_save_reference_checkpoint(
        params, jm.config, root, llama_config=jm.llama_config if include_base else None,
        lora_alpha=LORA["alpha"])
    if not include_base:
        jexport.save_peft_adapter(params["llm"], root, lora_alpha=LORA["alpha"])
    return root


def split_hf_base(root):
    """Move the HF base out of ``root`` into ``root + "_hf"``: with
    ``adapter_config.json`` beside it, ``transformers`` (which the JAX
    importer loads the base with) takes the directory for an adapter."""
    hf = root + "_hf"
    os.makedirs(hf)
    for name in ("config.json", "model.safetensors"):
        os.replace(os.path.join(root, name), os.path.join(hf, name))
    return hf


def port_from(root, **extra):
    model = tbci.BCI.from_config(PortDictConfig({"from_pt": root}), compute_dtype="float32",
                                 **method_kwargs(**extra))
    model.warm_start()
    return model.eval()


def test_jax_export_imports_into_the_port(pair, tmp_path):
    jm, params, _, batch = pair
    ref = jax_reference_dir(pair, str(tmp_path / "ref"))
    assert {"encoder.bin", "decoder.bin", "projector.bin", "encoder_config.pth",
            "projector_config.pth", "config.json", "model.safetensors",
            "adapter_model.safetensors", "adapter_config.json"} <= set(os.listdir(ref))
    jout = jm.apply({"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()})
    model = port_from(ref)
    # the structure came from the saved .pth configs
    assert model.config["projector"]["inter_size"] == 24
    assert model.config["ndt1"]["encoder"]["from_pt"] == ref
    with torch.no_grad():
        out = model(**tensors(batch))
    np.testing.assert_allclose(out.preds.numpy(), np.asarray(jout.preds), **FWD)
    np.testing.assert_allclose(out.loss.item(), float(jout.loss), rtol=1e-4)
    # load_ndt1_from_pt on the same directory: the inner NDT1 alone
    trunk = tbci.BCI.from_config(PortDictConfig(model_config()), compute_dtype="float32",
                                 **method_kwargs(load_ndt1_from_pt=ref))
    trunk.warm_start()
    for key, value in model.ndt1_encoder.state_dict().items():
        assert torch.equal(trunk.ndt1_encoder.state_dict()[key], value), key

    # an int8 base: the float weights are quantized before they load, as the
    # JAX importer does
    from llm_bci_tpu.models.llama import quantize_llama_params

    q = port_from(ref, quantize="int8")
    # the int8 model's tree: the float one's with quantized kernel leaves
    template = jax.tree_util.tree_map(
        np.zeros_like, {**params, "llm": quantize_llama_params(params["llm"], "int8")})
    hf = split_hf_base(ref)
    jq = jimport.bci_params_from_torch(ref, template, llama_config=jm.llama_config, llm_dir=hf,
                                       quant="int8", lora_r=LORA["r"], lora_alpha=LORA["alpha"])
    sd = q.state_dict()
    layer = jq["llm"]["layers_1"]["mlp"]["down_proj"]
    np.testing.assert_array_equal(sd["llm.model.layers.1.mlp.down_proj.kernel"].numpy(),
                                  layer["kernel"])
    np.testing.assert_array_equal(sd["llm.model.layers.1.mlp.down_proj.kernel_scale"].numpy(),
                                  layer["kernel_scale"])
    np.testing.assert_array_equal(sd["llm.model.layers.1.mlp.down_proj.lora_B"].numpy(),
                                  layer["lora_B"])


def test_port_export_reads_back_bit_equal_in_jax(pair, tmp_path):
    jm, params, tm, _ = pair
    out = str(tmp_path / "port_ref")
    texport.bci_save_reference_checkpoint(tm, out)
    template = jax.tree_util.tree_map(np.zeros_like, params)
    back = jimport.bci_params_from_torch(out, template, llama_config=jm.llama_config,
                                         llm_dir=split_hf_base(out), lora_r=LORA["r"],
                                         lora_alpha=LORA["alpha"])
    leaves = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert torch.load(os.path.join(out, "decoder.bin"), weights_only=True)["0.weight"].abs().sum() == 0
    with open(os.path.join(out, "adapter_config.json")) as f:
        acfg = json.load(f)
    assert (acfg["r"], acfg["lora_alpha"]) == (LORA["r"], LORA["alpha"])
    assert sorted(acfg["target_modules"]) == sorted(LORA["target_modules"])


def test_peft_adapter_config_is_validated(pair, tmp_path):
    ref = jax_reference_dir(pair, str(tmp_path / "ref"))
    path = os.path.join(ref, "adapter_config.json")
    with open(path) as f:
        good = json.load(f)
    cases = [
        ({"r": 4}, "trained with r=4 but the model is configured with lora.r=2"),
        ({"lora_alpha": 8.0}, "trained with lora_alpha=8.0 but the model is configured with "
                              "lora.alpha=16"),
        ({"rank_pattern": {"q_proj": 4}}, "per-module rank_pattern/alpha_pattern"),
        ({"use_rslora": True}, "use_rslora"),
    ]
    for change, message in cases:
        with open(path, "w") as f:
            json.dump({**good, **change}, f)
        with pytest.raises(ValueError, match=message):
            port_from(ref)
        # the JAX importer refuses the same file with the same words
        with pytest.raises(ValueError, match=message):
            jimport._validate_peft_adapter_config(path, LORA["r"], LORA["alpha"])


def test_projector_and_llm_strictness(pair, tmp_path):
    jm, params, tm, _ = pair
    ref = jax_reference_dir(pair, str(tmp_path / "ref"))
    # a single-Linear projector into a model with projector.inter_size
    proj = os.path.join(ref, "projector.bin")
    single = {"weight": torch.zeros(32, 32), "bias": torch.zeros(32)}
    torch.save(single, proj)
    msg = "checkpoint projector is a single Linear but the model was configured with"
    model = tbci.BCI.from_config(PortDictConfig(model_config()), compute_dtype="float32",
                                 **method_kwargs())
    with pytest.raises(ValueError, match=msg):
        model.load_checkpoint_params(ref)
    with pytest.raises(ValueError, match=msg):
        jimport.bci_params_from_torch(ref, params, llama_config=jm.llama_config)
    # neither full HF weights nor a peft adapter
    bare = str(tmp_path / "bare")
    jexport.bci_save_reference_checkpoint(params, jm.config, bare)
    msg = "holds neither full HF weights nor a peft adapter"
    with pytest.raises(ValueError, match=msg):
        model.load_checkpoint_params(bare)
    with pytest.raises(ValueError, match=msg):
        jimport.bci_params_from_torch(bare, params, llama_config=jm.llama_config)
    # the adapter alone (what PEFT's save_pretrained writes): the base keeps
    # the model's own weights, the factors come in
    jax_reference_dir(pair, bare, include_base=False)
    model.load_checkpoint_params(bare)
    np.testing.assert_array_equal(
        model.llm.model.layers[0].self_attn.q_proj.lora_B.detach().numpy(),
        params["llm"]["layers_0"]["self_attn"]["q_proj"]["lora_B"])


def test_eval_phonemes_reads_a_reference_checkpoint(pair, tmp_path):
    from llm_bci_tpu_torch import eval_phonemes as tep

    ref = jax_reference_dir(pair, str(tmp_path / "ref"))
    # the reference pickles its trainer config; a DictConfig subclass inside
    # unpickles as a plain dict
    torch.save(DictConfig(to_plain_dict(trainer_config(tmp_path))), os.path.join(ref, "trainer_config.pth"))
    save = str(tmp_path / "wer")
    args = tep.parse_args(["-k", f"from_pt={ref}", "beams=1", f"savestring={save}",
                           "test_len=2", "--device", "cpu"])
    metrics = tep.main(args, dataset=synth_bci_dataset(n_train=4, n_test=3),
                       tokenizer=WordTokenizer())
    assert np.isfinite(metrics["WER"]) and metrics["WER"] >= 0
    assert os.path.isfile(f"{save}.pkl")
