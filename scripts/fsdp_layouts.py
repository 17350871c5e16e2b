"""Which FSDP2 layouts of the port's plan train as the in-process trainer
does, on a one-rank NCCL group on the card.

    python3 scripts/fsdp_layouts.py        # from the root of a checkout, one GPU

A debug NDT1-CTC (2 x 32, float32, stochastic parts off, 3 steps on the
synthetic trials of ``tests/test_torch_port_trainer.py``'s shape) trains once
without a process group and then under five FSDP2 layouts: every parameter
in the root's one group, or a group for each module of
``parallel/mesh.py::fsdp_groups`` (``fsdp_min_size`` 64), with and without
resharding after the forward. Prints each layout's losses and whether they
equal the in-process ones (rtol 1e-5). Under torch 2.11 the root-only
layouts differ unless ``ModelOutput`` is a pytree node
(``llm_bci_tpu_torch/model_output.py``): FSDP2 then never hooks the root
group's backward, and its gradients are lost.
"""
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import _torch_parallel_worker as W  # noqa: E402
from llm_bci_tpu_torch.parallel import process  # noqa: E402
from llm_bci_tpu_torch.parallel.mesh import fsdp_groups  # noqa: E402
from llm_bci_tpu_torch.training import distributed as tdist  # noqa: E402
from llm_bci_tpu_torch.training import trainer as tr  # noqa: E402

C, V = 8, 41


def rows(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T, S = int(rng.integers(30, 41)), int(rng.integers(2, 7))
        idx = rng.integers(1, V, size=S)
        out.append({"spikes": rng.normal(size=(T, C)).astype(np.float32), "phonemes_idx": idx,
                    "phonemes": [f"P{j}" for j in idx], "sentence": "s",
                    "block_idx": np.asarray(i % 2), "day_idx": np.asarray(0)})
    return out


def config(tmp: str, tag: str) -> dict:
    pad = lambda: {"dim": 0, "side": "right", "value": 0, "truncate": None, "min_length": None}
    return {
        "seed": 3, "savestring": "p", "verbosity": 3,
        "dirs": {"checkpoint_dir": os.path.join(tmp, "ck" + tag), "log_dir": None},
        "training": {"num_epochs": 2, "train_batch_size": 4, "test_batch_size": 4,
                     "max_steps": 3, "save_on_preemption": False},
        "precision": {"compute_dtype": "float32"},
        "model": {"model_class": "NDT1", "encoder": {
            "masker": {"neuron": {"active": False}}, "smooth_and_noise": {"noise": False},
            "embedder": {"n_channels": C, "input_dim": 8, "max_F": 64, "dropout": 0.0,
                         "stack": {"active": True, "size": 4, "stride": 2}},
            "transformer": {"n_layers": 2, "hidden_size": 32, "n_heads": 4, "inter_size": 32,
                            "dropout": 0.0}}},
        "data": {"dataset_class": "decoding"},
        "method": {"model_kwargs": {"method_name": "ctc", "vocab_size": V, "blank_id": 0,
                                    "zero_infinity": True},
                   "dataset_kwargs": {"targets_name": "phonemes_idx"},
                   "dataloader_kwargs": {"pad_dict": {k: pad() for k in (
                       "spikes", "spikes_mask", "spikes_timestamp", "targets", "targets_mask")}},
                   "metric_kwargs": {}},
        "optimizer": {"lr": 1e-3, "wd": 5e-5, "scheduler": "cosine", "warmup_pct": 0.3},
    }


def layout(groups: bool, root_kw: dict, group_kw: dict):
    """An ``apply_plan`` that shards by one FSDP2 layout (no tensor
    parallelism: NDT1 has no Llama)."""
    from torch.distributed.fsdp import fully_shard

    def apply(model, mesh, min_size):
        dp = mesh["data", "fsdp"]
        for name in fsdp_groups(model, min_size) if groups else []:
            fully_shard(model.get_submodule(name), mesh=dp, **group_kw)
        fully_shard(model, mesh=dp, **root_kw)
        return tdist.Plan({}, mesh["tp"].get_group(), mesh["fsdp"].get_group())

    return apply


def main() -> None:
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    tmp = tempfile.mkdtemp(prefix="fsdp_layouts_")
    data = W.dump({"train": rows(10, 0), "test": rows(4, 1)}, os.path.join(tmp, "data.pkl"))
    par = {"data": 1, "fsdp": 1, "fsdp_min_size": 64}
    torch.manual_seed(0)
    weights = os.path.join(tmp, "w.pt")
    torch.save(tr.build_model(W._config(config(tmp, "w"), par), torch.device("cpu"))
               .state_dict(), weights)

    def run(tag: str) -> list:
        losses = []

        def record(model, model_inputs, unused_inputs, outputs, **kwargs):
            losses.append(float(outputs["loss"]))
            return 0.0

        cfg = W._config(config(tmp, tag), par)
        model = tr.build_model(cfg, torch.device("cpu"))
        model.load_state_dict(torch.load(weights, weights_only=True))
        trainer = tr.Trainer(cfg, model=model, dataset=W._load(data),
                             metric_fns={"rec": record}, device="cuda:0")
        trainer.train()
        torch.cuda.synchronize()
        return losses

    ref = run("ref")
    print("in-process", ref, flush=True)
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(process.free_port()))
    process.init_process("cuda:0")
    off = {"reshard_after_forward": False}
    for name, args in (("root group only, no reshard", (False, off, {})),
                       ("root group only", (False, {}, {})),
                       ("groups", (True, {}, {})),
                       ("groups, root no reshard", (True, off, {})),
                       ("groups, no reshard", (True, off, off))):
        tr.tdist.apply_plan = layout(*args)
        losses = run(name.replace(" ", "_").replace(",", ""))
        print(f"{name}: {losses} {'equal' if np.allclose(losses, ref, rtol=1e-5) else 'DIFFER'}",
              flush=True)


if __name__ == "__main__":
    main()
