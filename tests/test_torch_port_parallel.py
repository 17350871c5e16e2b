"""Multi-device training of the port on gloo CPU ranks (``parallel/``,
``training/distributed.py``), NDT1-CTC, held against the JAX package.

* pure functions against the JAX ones: ``mesh_shape`` / ``make_mesh`` sizes
  and errors against ``llm_bci_tpu.parallel.mesh.make_mesh``, the Llama TP
  plan against ``tp_llama_rules``' regexes, the ``fsdp_min_size`` grouping
  against ``fsdp_param_spec``, the batch rows (an indivisible batch kept
  whole);
* one group of 2 ranks (``tests/_torch_parallel_worker.py``, spawned once for
  the module) trains NDT1-CTC 3 steps on ``data=2`` and on ``fsdp=2``
  (dropout, noise and masker off, float32): the losses and final parameters
  against the port's single process (rtol 1e-5, atol 1e-6) and against the
  JAX trainer on the 8-device virtual mesh (rtol 1e-4, atol 1e-5; its results
  do not depend on the mesh); a checkpoint written by 2 ranks resumed in 1
  process, and one written by 1 process resumed in 2 ranks, bit-equal;
  preemption asked on rank 1 stops both ranks at one step; the flash keep
  mask and the training stream of data rank 0 equal the single process's,
  rank 1's differ (the pinned divergence);
* ``sp=2`` admits every family, refused only without a process group
  (``tests/test_torch_port_sequence_parallel*.py`` hold what ``sp`` does);
  ``dryrun_multichip(2)``.
"""
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu.parallel import mesh as jmesh
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.parallel import mesh as pmesh
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests import _torch_parallel_worker as W
from tests.test_torch_port_trainer import port_cfg, speechbci_rows, trainer_config

STEPS = 3
SINGLE = dict(rtol=1e-5, atol=1e-6)
JAX = dict(rtol=1e-4, atol=1e-5)
MESHES = {"data2": {"data": 2, "fsdp": 1}, "fsdp2": {"data": 1, "fsdp": 2}}


# ------------------------------------------------------------ pure functions

@pytest.mark.parametrize("sizes", [(-1, 1, 1, 1), (-1, 2, 2, 1), (2, -1, 1, 2), (2, 2, 2, 1),
                                   (1, 1, 1, -1), (4, 2, 1, 1)])
def test_mesh_sizes_match_jax(sizes):
    data, fsdp, tp, sp = sizes
    want = dict(jmesh.make_mesh(data, fsdp, tp, sp).shape)
    assert pmesh.mesh_shape(8, data, fsdp, tp, sp) == want


@pytest.mark.parametrize("sizes", [(-1, -1, 1, 1), (3, 2, 1, 1), (2, 2, 1, 1)])
def test_mesh_errors_match_jax(sizes):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(*sizes)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        pmesh.mesh_shape(8, *sizes)


def test_batch_rows_keep_the_data_shard_or_the_whole_batch():
    assert [pmesh.batch_rows(8, 2, i) for i in range(2)] == [(0, 4), (4, 8)]
    assert [pmesh.batch_rows(8, 4, i) for i in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    # the JAX trainer replicates a batch the data axis does not divide
    assert [pmesh.batch_rows(6, 4, i) for i in range(4)] == [(0, 6)] * 4
    assert pmesh.batch_rows(5, 1, 0) == (0, 5)
    assert pmesh.coordinates(5, {"data": 2, "fsdp": 2, "sp": 1, "tp": 2}) == {
        "data": 1, "fsdp": 0, "sp": 0, "tp": 1}


def _jax_path(name: str) -> str:
    """A port ``state_dict`` name as the JAX parameter path (flax names the
    (in, out) kernel what torch calls ``weight``)."""
    path = name.replace(".", "/")
    return re.sub(r"/weight$", "/kernel", path) if "proj" in path or "lm_head" in path else path


@pytest.mark.parametrize("quant", [None, "int8"])
def test_tp_plan_matches_jax_rules(quant):
    from llm_bci_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    llm = LlamaForCausalLM(LlamaConfig.debug(), lora_r=2, quant=quant,
                           lora_targets=("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                         "up_proj", "down_proj"))
    mesh = jmesh.make_mesh(2, 2, 2)
    rules = [(re.compile(k), tuple(v)) for k, v in jmesh.tp_llama_rules(mesh).items()]
    assert set(pmesh.TP_COLUMN) | set(pmesh.TP_ROW) == {
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}
    seen = set()
    for name in llm.state_dict():
        spec = next((v for k, v in rules if k.search(_jax_path(name))), ())
        # flax kernels are (in, out): tp on the last dim = output features
        want = ("column" if spec and spec[-1] == "tp" else
                "row" if spec and spec[0] == "tp" else "replicated")
        assert pmesh.tp_layout(name) == want, name
        seen.add(want)
    assert seen == {"column", "row", "replicated"}


def test_fsdp_groups_follow_fsdp_min_size():
    from llm_bci_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    llm = LlamaForCausalLM(LlamaConfig.debug(), lora_r=2, lora_targets=("q_proj", "v_proj"))
    mesh = jmesh.make_mesh(1, 8)
    for min_size in (64, 1024, 1 << 20):
        groups = set(pmesh.fsdp_groups(llm, min_size))
        for name, p in llm.named_parameters():
            leaf = np.zeros(tuple(p.shape), np.float32)
            sharded = jmesh.fsdp_param_spec((), leaf, mesh, min_size) != jax.sharding.PartitionSpec()
            owner = name.rpartition(".")[0]
            # a leaf JAX shards puts its module in a group of its own
            if sharded:
                assert owner in groups, (min_size, name)
        for owner in groups:
            assert any(p.numel() >= min_size
                       for p in llm.get_submodule(owner).parameters(recurse=False))
    assert pmesh.fsdp_groups(llm, 1 << 30) == []
    # deepest first: a child's group is made before its parent's
    names = pmesh.fsdp_groups(llm, 8)
    assert [n.count(".") for n in names] == sorted((n.count(".") for n in names), reverse=True)


@pytest.mark.parametrize("family", ["iTransformer", "PatchTST", "BCI", "PhonemeLLM"])
def test_sp_admits_every_family(tmp_path, family):
    # every family runs sequence-parallel
    # (tests/test_torch_port_sequence_parallel_{families,bci}.py): sp=2 is
    # refused only for want of a process group
    cfg = port_cfg(trainer_config(tmp_path))
    cfg["parallelism"] = {"data": 1, "fsdp": 1, "sp": 2}
    cfg["model"]["model_class"] = family
    with pytest.raises(ValueError, match="no process group is up"):
        PortTrainer(cfg, dataset={"train": [], "test": []}, device="cpu")
    cfg["model"]["model_class"] = "NDT1"
    cfg["parallelism"] = {"data": 1, "fsdp": 2}
    with pytest.raises(ValueError, match="no process group is up"):
        PortTrainer(cfg, dataset={"train": [], "test": []}, device="cpu")


# ---------------------------------------------------------- multi-rank runs

def _plain_config(tmp, tag):
    cfg = to_plain_dict(trainer_config(tmp / tag))
    cfg["training"].update(max_steps=STEPS, save_every=STEPS)
    return cfg


@pytest.fixture(scope="module")
def background():
    """A thread pool for the module's subprocess runs (gloo ranks, the dry
    run), which wait on their processes while this one compiles JAX."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        yield pool


@pytest.fixture(scope="module")
def dryrun(background):
    from llm_bci_tpu_torch.entry import dryrun_multichip

    return background.submit(dryrun_multichip, 2, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, background, dryrun):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("parallel")
    dataset = {"train": speechbci_rows(10, 0), "test": speechbci_rows(4, 1)}
    data_path = W.dump(dataset, tmp / "data.pkl")
    jax_losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        jax_losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    jcfg = trainer_config(tmp / "jax")
    jcfg["training"]["max_steps"] = STEPS
    jt = JaxTrainer(jcfg, dataset=dataset, metric_fns={"rec": record})
    weights = os.path.join(tmp, "weights.pt")
    torch.save(ndt1_state_dict_from_jax(jax.device_get(jt.state.params)), weights)

    single = W.train(_plain_config(tmp, "single"), {"data": 1, "fsdp": 1}, data_path, weights)
    # a 1-process checkpoint at step 2, resumed below in 2 ranks
    one = _plain_config(tmp, "one")
    one["training"].update(max_steps=2, save_every=2)
    one_run = W.train(one, {"data": 1, "fsdp": 1}, data_path, weights)

    cases = [(tag, "train", dict(plain=_plain_config(tmp, tag), parallelism=par,
                                 dataset_path=data_path, weights_path=weights))
             for tag, par in MESHES.items()]
    # one root group for every parameter (no leaf of the debug NDT1 reaches
    # the default fsdp_min_size), its backward hooked as torch 2.11 hooks it
    cases.append(("root", "train_hooked_by_tree_flatten", dict(
        plain=_plain_config(tmp, "root"), parallelism=MESHES["fsdp2"],
        dataset_path=data_path, weights_path=weights)))
    cases.append(("from_one", "resume", dict(plain=one, parallelism=MESHES["data2"],
                                             dataset_path=data_path, weights_path=weights)))
    preempt = _plain_config(tmp, "preempt")
    preempt["training"].update(max_steps=6, save_every=None, preemption_sync_every=2)
    cases.append(("preempt", "preempt", dict(
        plain=preempt, parallelism=MESHES["data2"], dataset_path=data_path,
        weights_path=weights, stop_rank=1, stop_after=3)))
    ranks = background.submit(W.run_ranks, tmp, 2, cases)
    jt.train()                                  # while the ranks run
    jax_final = ndt1_state_dict_from_jax(jax.device_get(jt.state.params))
    ranks = ranks.result()

    # the 2-rank checkpoint of the data2 run, resumed in one process
    resumed = W.resume(_plain_config(tmp, "data2"), {"data": 1, "fsdp": 1}, data_path, weights)
    return {"jax_losses": jax_losses, "jax_final": jax_final, "single": single,
            "one": one_run, "ranks": ranks, "resumed": resumed}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def _close(got, want, what, **tol):
    W.assert_states_close(got, want, what, lr=1e-3, steps=STEPS, **tol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ndt1_ctc_multi_rank_matches_the_single_process(runs, mesh):
    single = runs["single"]
    for rank, res in enumerate(runs["ranks"]):
        res = _ok(res[mesh])
        assert len(res["losses"]) == STEPS and res["n_micro"] == STEPS
        np.testing.assert_allclose(res["losses"], single["losses"], **SINGLE)
    _close(runs["ranks"][0][mesh]["model"], single["model"], mesh, **SINGLE)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ndt1_ctc_multi_rank_matches_the_jax_trainer(runs, mesh):
    res = _ok(runs["ranks"][0][mesh])
    np.testing.assert_allclose(res["losses"], runs["jax_losses"], **JAX)
    _close(res["model"], runs["jax_final"], mesh, **JAX)


def test_one_root_group_trains_as_the_single_process(runs):
    # FSDP2 hooks the root group's backward on the tensors of the forward's
    # output; torch 2.11 finds them with tree_flatten, so ModelOutput must be
    # a pytree node, or the root group's gradients never reach its shards
    single = runs["single"]
    for res in runs["ranks"]:
        res = _ok(res["root"])
        assert res["groups"] == []
        np.testing.assert_allclose(res["losses"], single["losses"], **SINGLE)
    _close(runs["ranks"][0]["root"]["model"], single["model"], "root", **SINGLE)


@pytest.mark.parametrize("module,name", [
    ("ndt1", "NDT1Output"), ("bci", "BCIOutput"), ("itransformer", "iTransformerOutput"),
    ("patchtst", "PatchTSTOutput"), ("phoneme_llm", "PhonemeLLMOutput")])
def test_model_outputs_are_pytree_nodes(module, name):
    import importlib

    from torch.utils._pytree import tree_flatten, tree_unflatten

    cls = getattr(importlib.import_module(f"llm_bci_tpu_torch.models.{module}"), name)
    loss, preds = torch.ones((), requires_grad=True), torch.zeros(2)
    out = cls(loss=loss, preds=preds)
    leaves, spec = tree_flatten(out)
    assert any(t is loss for t in leaves) and any(t is preds for t in leaves)
    back = tree_unflatten(leaves, spec)
    assert type(back) is cls and back.loss is loss and back.preds is preds


def test_fsdp_shards_the_parameters_and_data_keeps_them_whole(runs):
    whole = runs["single"]["shapes"]
    data2, fsdp2 = runs["ranks"][0]["data2"], runs["ranks"][0]["fsdp2"]
    assert _ok(data2)["local"] == {k: v for k, v in whole.items() if k in data2["local"]}
    name = "encoder.layers.0.attn.query.weight"
    assert fsdp2["local"][name][0] * 2 == whole[name][0]
    assert {r["fsdp2"]["coords"]["fsdp"] for r in runs["ranks"]} == {0, 1}
    assert {r["data2"]["coords"]["data"] for r in runs["ranks"]} == {0, 1}


def test_two_rank_checkpoint_resumes_in_one_process_bit_equal(runs):
    resumed = _ok(runs["resumed"])
    assert resumed["step"] == STEPS
    saved = runs["ranks"][0]["data2"]["model"]
    assert set(resumed["model"]) == set(saved)
    for key, value in saved.items():
        assert torch.equal(resumed["model"][key], value), key


def test_one_process_checkpoint_resumes_in_two_ranks_bit_equal(runs):
    saved = runs["one"]["model"]
    for rank in runs["ranks"]:
        res = _ok(rank["from_one"])
        assert res["step"] == 2
    res = runs["ranks"][0]["from_one"]
    for key, value in saved.items():
        assert torch.equal(res["model"][key], value), key
    assert res["optimizer"]["names"]


def test_preemption_on_one_rank_stops_both_at_one_step(runs):
    stops = [_ok(r["preempt"])["n_micro"] for r in runs["ranks"]]
    # asked on rank 1 after step 3; agreed at the next multiple of 2
    assert stops == [4, 4]
    assert "STEP4" in runs["ranks"][0]["preempt"]["saved"]


def test_data_ranks_fold_their_index_into_the_random_streams(runs):
    # the index is in the generators' seeds (train_seed), and the flash
    # dropout seed is drawn from the training generator
    single = runs["single"]
    r0, r1 = (r["data2"] for r in runs["ranks"])
    # data index 0 draws what one process draws ...
    assert torch.equal(r0["flash"], single["flash"])
    assert torch.equal(r0["draws"], single["draws"])
    # ... and data index 1 its own keep mask and stream (one process would
    # draw the rest of one stream: the pinned divergence)
    assert not torch.equal(r1["flash"], single["flash"])
    assert not torch.equal(r1["draws"], single["draws"])
    # fsdp ranks share a data index and so their streams
    f0, f1 = (r["fsdp2"] for r in runs["ranks"])
    assert torch.equal(f0["draws"], f1["draws"]) and torch.equal(f0["flash"], f1["flash"])


def test_dryrun_multichip_two_ranks(dryrun):
    from llm_bci_tpu_torch.entry import dryrun_meshes, dryrun_multichip

    assert "dryrun_multichip(2) OK" in dryrun.result()
    # without device="cpu" the ranks are cards, one each
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="runs one rank a card"):
            dryrun_multichip(2)
    assert dryrun_meshes(2) == ({"data": 1, "fsdp": 2, "sp": 1},
                                {"data": 1, "fsdp": 1, "tp": 2})
    assert dryrun_meshes(8) == ({"data": 2, "fsdp": 2, "sp": 2},
                                {"data": 2, "fsdp": 2, "tp": 2})
