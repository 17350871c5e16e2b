"""Serving export of the port (``llm_bci_tpu_torch/serving.py``) against the
JAX package's (``llm_bci_tpu/serving.py``), on the CPU, at the debug shapes of
``tests/test_serving_export.py``. Each test exports the same weights through
both exporters, the port's weights from ``interop/from_jax.py``:

* the BCI decode, greedy, beam and diverse beam, on a float32 and an int8
  base: the loaded port archive's ids equal the JAX artifact's and the port's
  in-process ``generate``; scores within atol 1e-4;
* the NDT1-CTC ``preds`` forward: rtol 1e-5 against the JAX artifact, no
  ``llm_bci.ctc_*`` node in the graph (one with ``outputs=("loss", ...)``);
* the iTransformer choice decoder with its masker's draw fixed at export:
  rtol 2e-5, atol 1e-6 against the JAX artifact (float32, as that file);
* the archive holds no weight and no example input: under max(weight bytes
  / 2, 1 MiB), as that file's bound, no lifted state, no example inputs and
  under 1 MiB of constant tables a program; a call with another input shape
  or without a weight is refused;
* ``load_decode`` in a fresh process that has only the path, the weights and
  the batch, and builds no model.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu import serving as jserving
from llm_bci_tpu_torch import serving
from llm_bci_tpu_torch.interop import itransformer_state_dict_from_jax, ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models.generation import greedy_decode
from tests.test_torch_port_itransformer import make_batch as it_batch
from tests.test_torch_port_itransformer import model_config as it_config
from tests.test_torch_port_itransformer import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_KEYS = ("input_ids", "attention_mask", "input_split", "spikes", "spikes_mask",
            "spikes_timestamp", "spikes_lengths", "block_idx", "day_idx")
NEW = 4


def random_bci(quantize=None, seed=0):
    """(JAX BCI in float32, seeded numpy params in the shapes of its ``init``,
    the port's BCI with the same weights, the batch): ``build_pair``'s models
    without the cost of a JAX ``init``."""
    from llm_bci_tpu.config import DictConfig
    from llm_bci_tpu.models import bci as jbci
    from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
    from llm_bci_tpu_torch.interop import bci_state_dict_from_jax
    from llm_bci_tpu_torch.models import bci as tbci
    from tests.test_torch_port_bci import make_batch, method_kwargs, model_config

    kwargs = method_kwargs(quantize=quantize)
    jm = jbci.BCI.from_config(DictConfig(model_config()), **kwargs).clone(dtype=jnp.float32)
    batch = make_batch()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed),
                            **{k: jnp.asarray(v) for k, v in batch.items()})["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if x.dtype == jnp.int8:
            return rng.integers(-127, 128, size=x.shape).astype(np.int8)
        if name in ("scale", "weight") and len(x.shape) == 1:      # norms
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        std = 0.02 / 127 * 4 if name == "kernel_scale" else 0.3 if "embed" in name else 0.1
        return (rng.normal(size=x.shape) * std + (std if name == "kernel_scale" else 0.0)
                ).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tm = tbci.BCI.from_config(PortDictConfig(model_config()), compute_dtype="float32", **kwargs)
    tm.load_state_dict(bci_state_dict_from_jax(params), strict=True)
    np_in = {k: np.ascontiguousarray(batch[k]) for k in GEN_KEYS}
    return jm, params, tm.eval(), np_in


@pytest.fixture(scope="module", params=[None, "int8"], ids=["float32", "int8"])
def bci(request, tmp_path_factory):
    """(JAX BCI, its params, the port's BCI with the same weights, the batch
    as numpy and as tensors, a directory, the greedy archives of both
    packages and their outputs)."""
    jm, params, tm, np_in = random_bci(request.param)
    t_in = {k: torch.from_numpy(v) for k, v in np_in.items()}
    tmp = tmp_path_factory.mktemp("serve")
    greedy = both(jm, params, tm, np_in, t_in, tmp, "greedy")
    return jm, params, tm, np_in, t_in, tmp, greedy


def both(jm, params, tm, np_in, t_in, tmp, name, **gen):
    """(the JAX artifact's output, the loaded port archive's, in-process
    ``generate``'s, the port archive's path, the loaded archive)."""
    jpath = jserving.export_decode(jm, params, np_in, str(tmp / f"{name}.jaxexport"),
                                   max_new_tokens=NEW, platforms=("cpu",), **gen)
    jout = jserving.load_decode(jpath)(params, np_in)
    path = serving.export_decode(tm, serving.params_of(tm), t_in, str(tmp / f"{name}.pt2"),
                                 max_new_tokens=NEW, **gen)
    fn = serving.load_decode(path)
    out = fn(serving.params_of(tm), t_in)
    return jout, out, tm.generate(**t_in, max_new_tokens=NEW, **gen), path, fn


def test_greedy_round_trip(bci):
    jout, out, ref, path, fn = bci[-1]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert torch.equal(out, ref)
    assert fn.device == torch.device("cpu")
    assert fn.signature["inputs"]["spikes"]["shape"] == list(bci[4]["spikes"].shape)
    int8 = [t for t in fn.archive.graph_targets("token_step") if t.startswith("llm_bci.")]
    assert set(int8) == ({"llm_bci.int8_matmul.default"} if bci[2].quant else set())
    t_in, w = bci[4], serving.params_of(bci[2])
    with torch.no_grad():      # the pieces of the decode, driven by the caller's own loop
        assert torch.equal(greedy_decode(*fn.parts(w, t_in), NEW, 2, 0), out)
    with pytest.raises(ValueError, match="spikes"):          # the shapes are static
        fn(w, {**t_in, "spikes": t_in["spikes"][:, :-1]})
    with pytest.raises(KeyError, match="params lack"):
        fn({k: v for k, v in w.items() if not k.startswith("llm.lm_head")}, t_in)


@pytest.mark.parametrize("gen", [
    dict(num_beams=3, length_penalty=0.8),
    dict(num_beams=3, num_beam_groups=3, diversity_penalty=1.2),
], ids=["beam", "diverse"])
def test_beam_round_trip(bci, gen):
    """The best sequence against the JAX artifact (the JAX exporter cannot
    write a ``BeamResult``; beam search on the float32 base: the int8 base
    and diverse beam share its programs), all hypotheses and their scores
    against in-process ``generate`` (which ``tests/test_torch_port_bci.py``
    holds against JAX)."""
    jm, params, tm, np_in, t_in, tmp, _ = bci
    if tm.quant is None and "num_beam_groups" not in gen:
        jout, out, ref, _, _ = both(jm, params, tm, np_in, t_in, tmp, "best", **gen)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert torch.equal(out, ref)
    path = serving.export_decode(tm, serving.params_of(tm), t_in, str(tmp / "all.pt2"),
                                 max_new_tokens=NEW, num_return_sequences=3, **gen)
    out = serving.load_decode(path)(serving.params_of(tm), t_in)
    ref = tm.generate(**t_in, max_new_tokens=NEW, num_return_sequences=3, **gen)
    assert torch.equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.scores.numpy(), ref.scores.numpy(), atol=1e-4)


def test_archive_holds_no_weight_or_example_input(bci):
    tm, path, fn = bci[2], bci[-1][3], bci[-1][4]
    n_param_bytes = sum(v.numel() * v.element_size() for v in serving.params_of(tm).values())
    assert os.path.getsize(path) < max(n_param_bytes // 2, 1 << 20)
    archive = fn.archive
    for ep in archive.exported.values():
        assert not ep.state_dict and ep.example_inputs is None
        assert sum(t.numel() * t.element_size() for t in ep.constants.values()) < 1 << 20


def test_load_decode_in_a_fresh_process(bci, tmp_path):
    tm, t_in, path = bci[2], bci[4], bci[-1][3]
    if tm.quant is not None:
        return      # one process is enough: the loader does not depend on the base
    torch.save({"params": serving.params_of(tm), "inputs": t_in}, tmp_path / "w.pt")
    code = f"""
import sys, torch
sys.path.insert(0, {REPO!r})
from llm_bci_tpu_torch import serving
from llm_bci_tpu_torch.models import bci
def refuse(*a, **k):
    raise AssertionError("a model was built")
bci.BCI.__init__ = refuse
blob = torch.load({str(tmp_path / 'w.pt')!r}, weights_only=True)
ids = serving.load_decode({path!r})(blob["params"], blob["inputs"])
torch.save(ids, {str(tmp_path / 'ids.pt')!r})
assert "jax" not in sys.modules and "llm_bci_tpu" not in sys.modules
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ids = torch.load(tmp_path / "ids.pt", weights_only=True)
    assert torch.equal(ids, bci[-1][2])


def _jax_variables(jmodel, seed, batch, **kw):
    """Seeded numpy values in the shapes of ``jmodel.init``'s params."""
    rng = np.random.default_rng(seed)
    init = lambda key, b: jmodel.init(key, **b, **kw)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})["params"]

    def leaf(path, x):
        near_one = path[-1].key == "scale"
        return (rng.normal(size=x.shape) * (0.1 if near_one else 0.05) + near_one).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_ndt1_ctc_preds_forward(tmp_path):
    import __graft_entry__ as graft
    from llm_bci_tpu_torch.entry import _ndt1_batch, _ndt1_ctc_model

    jm = graft._ndt1_ctc_model()
    full = graft._ndt1_batch()
    params = _jax_variables(jm, 0, full, training=False)
    serve = {k: v for k, v in full.items() if not k.startswith("targets")}
    const = {k: v for k, v in full.items() if k.startswith("targets")}
    jpath = jserving.export_forward(jm, params, serve, str(tmp_path / "ctc.jaxexport"),
                                    outputs=("preds",), const_inputs=const, platforms=("cpu",))
    jout = jserving.load_decode(jpath)(params, serve)

    tm = _ndt1_ctc_model().eval()
    tm.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)
    tfull = {k: torch.from_numpy(v) for k, v in _ndt1_batch().items()}
    tserve = {k: v for k, v in tfull.items() if not k.startswith("targets")}
    tconst = {k: v for k, v in tfull.items() if k.startswith("targets")}
    w = serving.params_of(tm)
    path = serving.export_forward(tm, w, tserve, str(tmp_path / "ctc.pt2"), outputs=("preds",),
                                  const_inputs=tconst)
    fn = serving.load_decode(path)
    out = fn(w, tserve)
    assert set(out) == {"preds"}
    np.testing.assert_allclose(out["preds"].numpy(), np.asarray(jout["preds"]), rtol=1e-5,
                               atol=1e-5)
    assert not [t for t in fn.archive.graph_targets("forward") if t.startswith("llm_bci.ctc")]

    path = serving.export_forward(tm, w, tserve, str(tmp_path / "loss.pt2"),
                                  outputs=("loss", "preds"), const_inputs=tconst)
    fn = serving.load_decode(path)
    ctc = [t for t in fn.archive.graph_targets("forward") if t.startswith("llm_bci.ctc")]
    assert ctc == ["llm_bci.ctc_alpha.default"]
    with torch.no_grad():
        ref = tm(**tfull)
    got = fn(w, tserve)
    assert torch.equal(got["loss"], ref.loss) and torch.equal(got["preds"], ref.preds)


def test_itransformer_choice_decoder_with_a_fixed_draw(tmp_path):
    from llm_bci_tpu.models import itransformer as jitr
    from llm_bci_tpu_torch.models import itransformer as tit

    # a force-active masker that draws (its zero / random draws), on a fixed
    # channel set, so that the JAX key and the port's generator give one mask
    cfg = it_config("stat_behaviour")
    cfg["masker"]["main"] = {"active": True, "force_active": True, "mode": "co-smooth",
                             "channels": [1, 4], "zero_ratio": 1.0, "random_ratio": 1.0}
    kw = dict(method_name="stat_behaviour", loss="xent", n_labels=3)
    jm = jitr.iTransformer.from_config(cfg, compute_dtype="float32", **kw)
    full = it_batch("stat_behaviour")
    params = random_variables(jm, 0, **{k: jnp.asarray(v) for k, v in full.items()})["params"]
    serve = {k: v for k, v in full.items() if not k.startswith("targets")}
    const = {k: v for k, v in full.items() if k.startswith("targets")}
    rngs = {"mask": jax.random.PRNGKey(7)}
    jpath = jserving.export_forward(jm, params, serve, str(tmp_path / "it.jaxexport"),
                                    outputs=("preds",), const_inputs=const, rngs=rngs,
                                    platforms=("cpu",))
    jout = jserving.load_decode(jpath)(params, serve)

    tm = tit.iTransformer.from_config(cfg, **kw).eval()
    tm.load_state_dict(itransformer_state_dict_from_jax(params), strict=True)
    t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    w = serving.params_of(tm)
    path = serving.export_forward(tm, w, t(serve), str(tmp_path / "it.pt2"), outputs=("preds",),
                                  const_inputs=t(const), rngs=7)
    out = serving.load_decode(path)(w, t(serve))["preds"]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout["preds"]), rtol=2e-5, atol=1e-6)

    # a mask that depends on the draw: the archive replays the draw of its
    # export's seed, which the in-process forward draws from that seed
    cfg["masker"]["main"] = {"active": True, "force_active": True, "mode": "neuron",
                             "ratio": 0.5, "zero_ratio": 1.0, "random_ratio": 1.0}
    tm = tit.iTransformer.from_config(cfg, **kw).eval()
    tm.load_state_dict(itransformer_state_dict_from_jax(params), strict=True)
    path = serving.export_forward(tm, w, t(serve), str(tmp_path / "n.pt2"), outputs=("preds",),
                                  const_inputs=t(const), rngs=7)
    fn = serving.load_decode(path)
    with torch.no_grad():
        ref = lambda seed: tm(**t(full), generator=torch.Generator().manual_seed(seed)).preds
        for _ in range(2):
            np.testing.assert_allclose(fn(w, t(serve))["preds"].numpy(), ref(7).numpy(),
                                       rtol=2e-5, atol=1e-6)
        assert (ref(7) - ref(8)).abs().max() > 1e-2
