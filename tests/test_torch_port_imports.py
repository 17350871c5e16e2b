"""The port imports torch, never JAX and nothing of the JAX package.

The check runs in a subprocess: this test process has JAX loaded already
(``tests/conftest.py`` imports it). The subprocess forbids ``jax``, ``flax``,
``optax``, ``orbax``, ``triton``, ``transformers``, ``safetensors``,
``datasets``, ``matplotlib`` and the exact top-level name ``llm_bci_tpu``
outright, imports
every module of ``llm_bci_tpu_torch`` (``eval_phonemes`` and
``eval.co_smoothing`` among them),
runs a tiny NDT1-CTC and a tiny NDT1-mlm forward and backward on the CPU (the
latter through the flash branch) and a tiny int8 BCI forward, backward and
greedy decode (again under the tensor-parallel plan on a one-rank gloo
group: the same loss and ids), the BCI's reference-format export (HF base,
PEFT adapter) read back by ``from_pt``, and then checks that none of those was loaded and that no
kernel was built. On a CPU tensor ``int8_matmul`` takes the plain version,
and the CUDA wrapper handed a CPU tensor raises instead of falling back."""
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "llm_bci_tpu_torch")

SCRIPT = r'''
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "triton", "transformers", "safetensors",
           "datasets", "matplotlib", "llm_bci_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Block())

import numpy as np
import torch
import llm_bci_tpu_torch

for mod in pkgutil.walk_packages(llm_bci_tpu_torch.__path__, "llm_bci_tpu_torch."):
    # native/_editdistance.so is a ctypes library built at first use, not a module
    if importlib.util.find_spec(mod.name).origin.endswith(".py"):
        importlib.import_module(mod.name)
assert {"llm_bci_tpu_torch.eval_phonemes", "llm_bci_tpu_torch.eval.co_smoothing",
        "llm_bci_tpu_torch.models.phoneme_llm", "llm_bci_tpu_torch.data.ibl",
        "llm_bci_tpu_torch.parallel.mesh", "llm_bci_tpu_torch.parallel.process",
        "llm_bci_tpu_torch.parallel.tensor_parallel",
        "llm_bci_tpu_torch.training.distributed"} <= set(sys.modules)

from llm_bci_tpu_torch.models.ndt1 import NDT1

cfg = {"encoder": {
    "masker": {"neuron": {"active": False}},
    "embedder": {"n_channels": 6, "input_dim": 8, "max_F": 64,
                 "stack": {"active": True, "size": 4, "stride": 2}},
    "transformer": {"n_layers": 1, "hidden_size": 16, "n_heads": 2, "inter_size": 16},
}}
model = NDT1.from_config(cfg, method_name="ctc", vocab_size=11)
rng = np.random.default_rng(0)
B, T = 2, 30
out = model(
    spikes=torch.from_numpy(rng.normal(size=(B, T, 6)).astype(np.float32)),
    spikes_mask=torch.ones(B, T, dtype=torch.int64),
    spikes_timestamp=torch.arange(T).expand(B, T),
    spikes_lengths=torch.tensor([T, T - 5]),
    targets=torch.tensor([[1, 2, 3], [4, 4, 0]]),
    targets_lengths=torch.tensor([3, 2]),
    generator=torch.Generator().manual_seed(0),
)
out.loss.backward()
assert torch.isfinite(out.loss)
assert all(p.grad is not None for p in model.parameters())
assert tuple(out.preds.shape) == (B, 14, 11)

# NDT1-mlm through the flash branch (the plain version of the kernels here)
cfg = {"encoder": {
    "masker": {"neuron": {"active": True, "mode": "random", "ratio": 0.3}},
    "embedder": {"n_channels": 6, "input_dim": 8, "max_F": 64, "stack": {"active": False}},
    "transformer": {"n_layers": 1, "hidden_size": 16, "n_heads": 2, "inter_size": 16,
                    "flash_attention": True},
}}
model = NDT1.from_config(cfg, method_name="mlm")
assert model.encoder._use_flash_now(T)
mask = torch.ones(B, T, dtype=torch.int64)
mask[1, :7] = 0
out = model(
    spikes=torch.from_numpy(rng.poisson(1.0, size=(B, T, 6)).astype(np.float32)),
    spikes_mask=mask,
    spikes_timestamp=torch.arange(T).expand(B, T),
    spikes_lengths=torch.tensor([T, T - 7]),
    generator=torch.Generator().manual_seed(0),
)
out.loss.backward()
assert torch.isfinite(out.loss) and int(out.n_examples) > 0
assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())

# BCI with an int8 Llama base: forward, backward, greedy decode on the CPU
from llm_bci_tpu_torch.models.bci import BCI
from llm_bci_tpu_torch.registry import NAME2MODEL

assert NAME2MODEL["BCI"] is BCI
bci = BCI.from_config(
    {"ndt1": cfg | {"encoder": cfg["encoder"] | {
        "masker": {"neuron": {"active": False}},
        "embedder": {"n_channels": 6, "input_dim": 8, "max_F": 64,
                     "stack": {"active": True, "size": 4, "stride": 2}}}},
     "projector": {"stacking": 1, "inter_size": 8, "bias": True, "act": "relu"}},
    debug=True, quantize="int8", compute_dtype="float32",
    lora={"r": 2, "alpha": 4, "dropout": 0.0, "target_modules": ["q_proj", "down_proj"]},
)
L = 5
inputs = dict(
    input_ids=torch.from_numpy(rng.integers(3, 100, size=(B, L))),
    attention_mask=torch.ones(B, L, dtype=torch.int64),
    input_split=torch.tensor([2, 0]),
    spikes=torch.from_numpy(rng.poisson(1.0, size=(B, T, 6)).astype(np.float32)),
    spikes_mask=torch.ones(B, T, dtype=torch.int64),
    spikes_timestamp=torch.arange(T).expand(B, T),
)
out = bci(**inputs, targets=torch.tensor([[-100, -100, 5, 6, 7], [-100, 9, 8, 7, 6]]))
out.loss.backward()
assert torch.isfinite(out.loss) and tuple(out.preds.shape) == (B, L + 14, 32000)
assert bci.llm.lm_head.kernel.dtype == torch.int8
assert all((p.grad is not None) == p.requires_grad for p in bci.parameters())
tokens = bci.generate(**inputs, max_new_tokens=3)
assert tuple(tokens.shape) == (B, 3)

# the tensor-parallel plan on a one-rank gloo group: the same loss and ids
import torch.distributed as dist
from llm_bci_tpu_torch.parallel import process
from llm_bci_tpu_torch.parallel.tensor_parallel import apply_tp_plan

targets = torch.tensor([[-100, -100, 5, 6, 7], [-100, 9, 8, 7, 6]])
bci.eval()
with torch.no_grad():
    before = bci(**inputs, targets=targets).loss
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{process.free_port()}",
                            rank=0, world_size=1)
    apply_tp_plan(bci.llm, dist.group.WORLD)
    assert torch.equal(bci(**inputs, targets=targets).loss, before)
assert torch.equal(bci.generate(**inputs, max_new_tokens=3), tokens)
dist.destroy_process_group()
bci.train()

# the reference format both ways: the int8 BCI's encoder, projector and LoRA
# factors (a PEFT adapter; an int8 base has no HF export), and a float BCI
# whole (the HF base in model.safetensors)
import tempfile
from llm_bci_tpu_torch.interop.torch_export import bci_save_reference_checkpoint

with torch.no_grad():
    for name, p in bci.named_parameters():
        if name.endswith("lora_B"):
            p.normal_()
float_bci = BCI.from_config(
    {"ndt1": bci.config["ndt1"], "projector": bci.config["projector"]}, debug=True,
    compute_dtype="float32", lora={"r": 2, "alpha": 4, "dropout": 0.0,
                                   "target_modules": ["q_proj", "down_proj"]})
with tempfile.TemporaryDirectory() as ref:
    bci_save_reference_checkpoint(bci, ref, include_base=False)
    bci_save_reference_checkpoint(float_bci, ref + "/float")
    back = BCI.from_config({"from_pt": ref}, debug=True, quantize="int8",
                           compute_dtype="float32",
                           lora={"r": 2, "alpha": 4, "dropout": 0.0,
                                 "target_modules": ["q_proj", "down_proj"]})
    back.warm_start()
    want, got = bci.state_dict(), back.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items()
               if ".lora_" in k or k.startswith(("ndt1_encoder.", "projector")))
    again = BCI.from_config({"from_pt": ref + "/float"}, debug=True, compute_dtype="float32",
                            lora={"r": 2, "alpha": 4, "dropout": 0.0,
                                  "target_modules": ["q_proj", "down_proj"]})
    again.warm_start()
    assert all(torch.equal(again.state_dict()[k], v) for k, v in float_bci.state_dict().items())

# importing the CUDA wrappers built and loaded nothing
from llm_bci_tpu_torch.ops import _build, ctc_cuda, flash_attention_cuda, int8_matmul_cuda
assert flash_attention_cuda._LIB is None and ctc_cuda._LIB is None and not _build._LOADED
assert int8_matmul_cuda._LIB is None and int8_matmul_cuda.LAUNCHES == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
assert "jax" not in sys.modules
print("PORT_OK")
'''


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PORT_OK" in proc.stdout


IMPORT_PATTERN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|llm_bci_tpu)(\.|\s|$)", re.M)


def port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def test_no_source_file_imports_jax():
    offenders = []
    for path in port_sources():
        with open(path) as f:
            if IMPORT_PATTERN.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


@pytest.mark.parametrize("line,caught", [
    ("from llm_bci_tpu.config import DictConfig", True),
    ("    import llm_bci_tpu.data  # noqa", True),
    ("import llm_bci_tpu", True),
    ("from llm_bci_tpu import registry", True),
    ("import jax.numpy as jnp", True),
    ("from llm_bci_tpu_torch.config import DictConfig", False),
    ("import llm_bci_tpu_torch.data", False),
    ("# from llm_bci_tpu.config import x", False),
])
def test_import_pattern_catches_the_jax_package(line, caught):
    assert bool(IMPORT_PATTERN.search("import os\n" + line + "\n")) == caught


def test_int8_matmul_on_the_cpu_is_plain_and_the_cuda_wrapper_raises():
    from llm_bci_tpu_torch.ops import int8_matmul_cuda, quant

    x = torch.randn(3, 32)
    q = torch.randint(-127, 128, (32, 48), dtype=torch.int8)
    scale = torch.rand(48)
    assert torch.equal(quant.int8_matmul(x, q, scale), quant.int8_matmul_plain(x, q, scale))
    with pytest.raises(ValueError, match="expected a CUDA device"):
        int8_matmul_cuda.int8_matmul_cuda(x, q, scale, torch.float32)
    assert int8_matmul_cuda.LAUNCHES == 0 and int8_matmul_cuda._LIB is None


def test_tokenizer_and_hf_loader_import_transformers_lazily():
    """``transformers`` appears only inside the functions that need it."""
    for rel in ("main.py", "eval_phonemes.py", os.path.join("models", "llama.py")):
        with open(os.path.join(PKG, rel)) as f:
            lines = [ln for ln in f.read().splitlines() if "transformers import" in ln]
        assert lines and all(ln.startswith("    ") for ln in lines), (rel, lines)


def test_trainer_without_cuda_raises(monkeypatch):
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.training.trainer import Trainer

    # no card (this holds on a machine with one too)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(DictConfig({}), device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(DictConfig({}), device="cuda")
