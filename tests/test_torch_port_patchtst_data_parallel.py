"""PatchTST under data parallelism (``parallelism.data``) on gloo CPU ranks:
BatchNorm's training statistics are those of the global batch, as the JAX
trainer's program takes them, and its running averages move alike on every
rank.

Two groups (``tests/_torch_parallel_worker.py``, each spawned once for the
module), 2 ranks at ``(data=2)`` and 4 at ``(data=2, fsdp=2)``, train the
debug PatchTST (BatchNorm, ``std`` scaling) 4 steps, float32, with ``ctc``
and ``mlm`` (its masking noise fixed): 9 rows in batches of 4 give a last
batch of one row, which ``data`` does not divide and every rank then holds
whole. Losses within rtol 1e-5 of one process and parameters within atol
1e-5 (the fused ``qkv`` bias's key third, whose gradient is rounding noise,
within what Adam can move it); the running averages the same on every rank
and within rtol 1e-5 of one process's, in the whole state that rank 0
writes to a checkpoint too; the eval after the last step equal to one
process's. ``ctc`` at ``(data=2)`` within rtol 1e-4 of the JAX trainer's
``{data: 2, fsdp: 4}`` run on the conftest's 8 virtual CPU devices.
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import DictConfig as JaxDictConfig
from llm_bci_tpu_torch.interop import patchtst_state_dict_from_jax

from tests import _torch_parallel_worker as W
from tests.test_torch_port_sequence_parallel_families import _close, pt_config, pt_rows

STEPS = 4
LOSS = dict(rtol=1e-5)
RUNNING = dict(rtol=1e-5, atol=1e-7)
JAX = dict(rtol=1e-4)
ONE = {"data": 1, "fsdp": 1}
MESHES = {"data2": (2, {"data": 2, "fsdp": 1}), "data2_fsdp2": (4, {"data": 2, "fsdp": 2})}
JAX_MESH = {"data": 2, "fsdp": 4}
N_TRAIN, BATCH = 9, 4            # batches of 4, 4 and 1 rows
KIND = {"ctc": "train", "mlm": "train_fixed_noise"}


def _jax_run(plain, dataset):
    """The JAX trainer's ``{data: 2, fsdp: 4}`` run: its initial weights as
    a port state dict (with the running averages) and its per-step losses."""
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    cfg = copy.deepcopy(plain)
    cfg["parallelism"] = dict(JAX_MESH)
    cfg["training"]["eval_every"] = None
    jt = JaxTrainer(JaxDictConfig(cfg), dataset=dataset, metric_fns={"rec": record})
    state = patchtst_state_dict_from_jax(jax.device_get(
        {"params": jt.state.params, **jt.state.extra_vars}))
    return jt, state, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from llm_bci_tpu_torch.training.trainer import build_model

    tmp = tmp_path_factory.mktemp("patchtst_data_parallel")
    data = {"train": pt_rows(N_TRAIN, 2), "test": pt_rows(4, 3)}
    data_path = W.dump(data, tmp / "pt.pkl")
    plains = {m: pt_config(tmp / m, m, False) for m in KIND}
    weights = {m: os.path.join(str(tmp), f"{m}.pt") for m in KIND}
    jt, state, jax_losses = _jax_run(plains["ctc"], data)
    torch.save(state, weights["ctc"])
    torch.manual_seed(0)
    torch.save(build_model(W._config(plains["mlm"], ONE), torch.device("cpu")).state_dict(),
               weights["mlm"])

    def case(m, parallelism, tag):
        plain = copy.deepcopy(plains[m])
        plain["savestring"] = tag
        plain["training"]["train_batch_size"] = BATCH
        return dict(plain=plain, parallelism=parallelism, dataset_path=data_path,
                    weights_path=weights[m])

    with ThreadPoolExecutor(max_workers=len(MESHES)) as pool:
        pending = {}
        for tag, (n, par) in MESHES.items():
            os.makedirs(tmp / tag)
            pending[tag] = pool.submit(W.run_ranks, tmp / tag, n,
                                       [(m, KIND[m], case(m, par, f"{m}_{tag}")) for m in KIND])
        jt.train()
        single = {m: getattr(W, KIND[m])(**case(m, ONE, f"{m}_single")) for m in KIND}
        ranks = {tag: future.result() for tag, future in pending.items()}
    return {"ranks": ranks, "single": single, "jax": jax_losses}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


CASES = [(tag, m) for tag in MESHES for m in KIND]


@pytest.mark.parametrize("tag,method", CASES)
def test_data_parallel_patchtst_trains_as_the_single_process(runs, tag, method):
    single = runs["single"][method]
    assert len(single["losses"]) >= STEPS and -(-N_TRAIN // BATCH) == 3
    for rank in runs["ranks"][tag]:
        res = _ok(rank[method])
        assert res["n_micro"] == STEPS and res["coords"]["data"] in (0, 1)
        # step 3 is the batch of one row, whole on every rank
        np.testing.assert_allclose(res["losses"], single["losses"], **LOSS)
        (ev,) = res["eval"]
        (want,) = single["eval"]
        np.testing.assert_allclose(ev["test_avg_loss"], want["test_avg_loss"], **LOSS)
        assert res["pred_shapes"] == single["pred_shapes"]
    _close(runs["ranks"][tag][0][method]["model"], single["model"], f"{method} {tag}")


@pytest.mark.parametrize("tag,method", CASES)
def test_running_averages_are_the_global_batchs_on_every_rank(runs, tag, method):
    single = runs["single"][method]["buffers"]
    assert len(single) == 2 * 2 * 2        # 2 layers x 2 norms x (mean, var)
    ranks = [_ok(r[method]) for r in runs["ranks"][tag]]
    for res in ranks:
        assert set(res["buffers"]) == set(single)
        for k, v in res["buffers"].items():
            assert torch.equal(v, ranks[0]["buffers"][k]), (tag, method, k)
            torch.testing.assert_close(v, single[k], **RUNNING)
    # the whole state rank 0 writes to a checkpoint holds them
    state = ranks[0]["model"]
    for k, v in single.items():
        torch.testing.assert_close(state[k], v, **RUNNING)


def test_data_parallel_patchtst_matches_the_jax_trainer(runs):
    losses = _ok(runs["ranks"]["data2"][0]["ctc"])["losses"]
    assert len(runs["jax"]) == STEPS
    np.testing.assert_allclose(losses[:STEPS], runs["jax"], **JAX)
