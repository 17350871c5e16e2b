"""The ``kernels`` line of ``chip_smoke.py`` names kernels that exist: each
entry of ``chip_smoke.KERNELS`` is a ``__global__`` function of that name in
its CUDA source, inside the namespaces its name gives, and the TPU kernel it
replaces is the line it names in the JAX package. The int8 wrapper counts its
launches by the kernel each regime runs, under the same names."""
import os
import re

import pytest

import chip_smoke
from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_defined(name: str, source: str) -> None:
    """``name`` (``namespace::kernel``) is a ``__global__`` function of
    ``source`` inside those namespaces."""
    with open(os.path.join(REPO, source)) as f:
        text = f.read()
    *spaces, kernel = name.split("::")
    found = [m.start() for m in re.finditer(r"__global__[^;{]*?\b%s\(" % kernel, text)]
    assert found, f"{kernel} is not a __global__ function of {source}"
    for space in spaces:
        begin = text.index(f"namespace {space} {{")
        end = text.index(f"}}  // namespace {space}", begin)
        assert any(begin < at < end for at in found), f"{kernel} is not inside {space}"


@pytest.mark.parametrize("name", sorted(chip_smoke.KERNELS))
def test_each_kernel_of_the_line_is_defined_in_its_source(name):
    source, replaces = chip_smoke.KERNELS[name]
    assert source.startswith("llm_bci_tpu_torch/csrc/") and source.endswith(".cu")
    assert_defined(name, source)
    path, line = replaces.rsplit(":", 1)
    with open(os.path.join(REPO, path)) as f:
        lines = f.read().splitlines()
    # the line of the TPU kernel's function (or of the expression it fuses)
    assert re.match(r"def _\w*kernel\(|\s+delta = ", lines[int(line) - 1]), lines[int(line) - 1]


def test_the_timed_kernels_are_the_redesigned_ones():
    """At the timed shapes the wgmma / cluster kernels run, not the first
    versions that float32 and other head sizes keep."""
    names = set(chip_smoke.KERNELS)
    assert {"fwd_wg::flash_fwd_wgmma_kernel", "bwd_wg::flash_dq_wgmma_kernel",
            "bwd_wg::flash_dkv_wgmma_kernel", "cluster::int8_cluster_kernel",
            "tiled::int8_wgmma_kernel"} <= names
    assert not names & {"flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                        "int8_matmul_small_m", "int8_matmul_tiled"}


@pytest.mark.parametrize("kind,M,bf16", [("cluster", 1, True), ("cluster", 64, True),
                                         ("tiled", 65, True), ("f32", 8, False),
                                         ("f32", 1480, False)])
def test_int8_launches_are_counted_by_the_kernel_that_runs(kind, M, bf16):
    """A call's regime names the kernel it launches; the launch dictionaries of
    ``chip_smoke.py`` read the cluster and tiled counts under those names."""
    assert ic.regime(M, bf16) == kind
    assert_defined(ic.REGIME_KERNELS[kind], "llm_bci_tpu_torch/csrc/int8_matmul.cu")
    assert set(ic.REGIME_LAUNCHES) == set(ic.REGIME_KERNELS)
    assert {chip_smoke.INT8_CLUSTER: "cluster", chip_smoke.INT8_TILED: "tiled"} == {
        ic.REGIME_KERNELS[k]: k for k in ("cluster", "tiled")}
    ic.reset_counters()
    assert set(chip_smoke.int8_launches()) == {chip_smoke.INT8_CLUSTER, chip_smoke.INT8_TILED}
    assert ic.LAUNCHES == 0 and not any(ic.REGIME_LAUNCHES.values())


# each custom op and the kernels of ``KERNELS`` its CUDA body launches
OP_KERNELS = {
    "ctc_alpha": ["ctc_alpha_kernel"],
    "ctc_alpha_beta": ["ctc_alpha_beta_kernel"],
    "flash_fwd": ["fwd_wg::flash_fwd_wgmma_kernel"],
    "flash_bwd": ["flash_delta_kernel", "bwd_wg::flash_dq_wgmma_kernel",
                  "bwd_wg::flash_dkv_wgmma_kernel"],
    "int8_matmul": ["cluster::int8_cluster_kernel", "tiled::int8_wgmma_kernel"],
}


@pytest.mark.parametrize("op", sorted(OP_KERNELS))
def test_each_custom_op_has_a_cpu_and_a_cuda_body_and_launches_named_kernels(op):
    """Every kernel of the line is reached through one ``llm_bci`` op, whose
    dispatch keys are the CPU (the plain version) and CUDA (the kernel) and
    no other backend; the op's fake gives shapes to a trace."""
    import torch

    from llm_bci_tpu_torch.ops import ctc, flash_attention, quant  # noqa: F401  (registrations)

    name = f"llm_bci::{op}"
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (op, key)
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(name, "XLA")
    assert torch._library.simple_registry.singleton.find(name).fake_impl.kernel is not None
    for kernel in OP_KERNELS[op]:
        assert kernel in chip_smoke.KERNELS
    assert sorted(k for ks in OP_KERNELS.values() for k in ks) == sorted(chip_smoke.KERNELS)
