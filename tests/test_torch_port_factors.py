"""NDT1's active factors projection (``NeuralFactorsProjection``) against the
JAX package, for the ``ctc`` and ``mlm`` heads, with ``fixup_init`` on and
off. The JAX weights, ``out_proj/proj`` among them, are carried by
``ndt1_state_dict_from_jax``; eval mode, float32. Forward atol 1e-5 / rtol
1e-4, loss rtol 1e-4; parameter gradients rtol 1e-3 with an absolute floor of
1e-5 of the largest entry (as ``tests/test_torch_port_ndt1_mlm.py``: the
Poisson loss's exp amplifies rounding). The port's own initialisation follows
the JAX one: under ``fixup_init`` a weight uniform in +-``init_range`` and a
zero bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import ndt1 as jndt1
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models import ndt1 as tndt1

from tests import test_torch_port_ndt1 as ctc_case
from tests import test_torch_port_ndt1_mlm as mlm_case

FACTORS = 12


def case(method, fixup):
    mod = ctc_case if method == "ctc" else mlm_case
    cfg = mod.model_config()
    cfg["encoder"]["factors"] = {"active": True, "size": FACTORS, "act": "relu", "bias": True,
                                 "dropout": 0.0, "fixup_init": fixup, "init_range": 0.1}
    kwargs = {"method_name": method}
    if method == "ctc":
        kwargs.update(vocab_size=ctc_case.V, blank_id=0, zero_infinity=True)
    return cfg, kwargs, mod.make_batch()


@pytest.mark.parametrize("fixup", [False, True], ids=["torch_init", "fixup"])
@pytest.mark.parametrize("method", ["ctc", "mlm"])
def test_factors_projection_matches_jax(method, fixup):
    cfg, kwargs, batch = case(method, fixup)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}
    jmodel = jndt1.NDT1.from_config(cfg, compute_dtype="float32", **kwargs)
    init = jax.jit(lambda r, b: jmodel.init(r, **b, training=False)["params"])
    params = jax.device_get(init(rngs, jb))
    proj = params["encoder"]["out_proj"]["proj"]
    if fixup:
        assert np.abs(proj["kernel"]).max() <= 0.1 and not np.asarray(proj["bias"]).any()

    def apply(p):
        out = jmodel.apply({"params": p}, **jb, training=False,
                           rngs={"mask": jax.random.PRNGKey(1)})
        return out.loss, out.preds

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(apply, has_aux=True))(params)
    jgrads = ndt1_state_dict_from_jax(jax.device_get(jgrads))

    torch.manual_seed(0)
    tmodel = tndt1.NDT1.from_config(cfg, **kwargs)
    layer = tmodel.encoder.out_proj.proj[0]
    assert tmodel.decoder.in_features == FACTORS == layer.out_features
    if fixup:
        assert float(layer.weight.detach().abs().max()) <= 0.1 and not layer.bias.any()
    sd = ndt1_state_dict_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict(sd, strict=True)
    out = tmodel.eval()(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    out.loss.backward()
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(jpreds), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(out.loss.item(), float(jloss), rtol=1e-4)
    grads = dict(tmodel.named_parameters())
    floor = 1e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), rtol=1e-3, atol=floor,
                                   err_msg=name)
    assert float(jgrads["encoder.out_proj.proj.0.weight"].abs().max()) > 0
