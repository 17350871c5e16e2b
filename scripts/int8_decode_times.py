#!/usr/bin/env python3
"""Device time of the port's int8 dequant-matmul at the Llama-2-7B decode
shapes, for one tree of this repository, on one NVIDIA GPU.

    python3 scripts/int8_decode_times.py [--tree DIR] [--label NAME] [--sweep]

``llm_bci_tpu_torch`` is imported from ``DIR`` (default: this checkout), so
that the kernels of two trees (another commit unpacked with ``git archive``
into the git-ignored ``_checkout/``) can be timed in turns on one machine:
run it for each tree in the order A, B, B, A and compare within the run. The
kernels are built from ``DIR``'s sources at the first call.

At each (K, N) of the four decode shapes (q/k/v/o, gate/up, down, lm_head)
and M in {8, 40} (greedy and 5-beam token steps at B=8), with bf16 ``x`` and
a bf16 result: the wrapper ``int8_matmul_cuda`` held once against the tree's
``int8_matmul_plain`` (rtol 2^-8, atol 1e-4 x max|out|, as ``chip_smoke.py``),
then its device time from a CUDA graph of 20 calls, each call on another copy
of the weight from a ring larger than the 50 MB L2 (``chip_smoke.graph_ms``);
``torch.matmul`` on a bf16 copy of the weight timed the same way; the byte
bound; the wrapper's eager time (CUDA events around the calls one by one,
the host's enqueue included). ``--sweep`` (a tree whose kernel splits K over
a thread-block cluster, ``cluster_plan``) adds the device time of every
cluster size that leaves no rank empty, beside the plan's.

Prints the card's name and power limit, then one JSON object a cell.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (timing helpers and shapes; it
    imports nothing of the port at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plan_text(ic, M: int, K: int, N: int) -> str:
    if hasattr(ic, "cluster_plan"):
        p = ic.cluster_plan(M, K, N)
        return (f"cluster C={p.cluster} x {p.grid[1]} column tiles, {p.k_per_rank // 64} k-tiles "
                f"a rank, {p.stages} stages")
    config, split, k_per_split = ic.plan(M, K, N, True)
    return (f"split-K: config {config}, {split} splits of {k_per_split} x {-(-N // 128)} "
            f"column tiles, then the reduce pass")


def sweep(cs, ic, x, next_q, scale, reps: int) -> dict:
    """Device time of the cluster kernel by cluster size (the plan's with
    ``*``); a size the launcher refuses gives its error code."""
    import torch

    M, K = x.shape
    q = next_q()
    N = q.shape[1]
    plan = ic.cluster_plan(M, K, N)
    out = torch.empty((M, N), device=x.device, dtype=torch.bfloat16)
    k_tiles = -(-K // ic.CLUSTER_K)
    cells = {}
    for c in ic.CLUSTER_SIZES:
        per_rank = -(-k_tiles // c)
        if (c - 1) * per_rank >= k_tiles:
            continue
        alt = plan._replace(cluster=c, k_per_rank=per_rank * ic.CLUSTER_K, grid=(c, plan.grid[1]))
        name = f"{'*' if alt == plan else ''}C={c}"
        rc = cs.raw_cluster_launch(x, q, scale, out, alt)     # set-up outside the capture
        torch.cuda.synchronize()
        cells[name] = (f"refused ({rc})" if rc else
                       cs.graph_ms(lambda: cs.raw_cluster_launch(x, next_q(), scale, out, alt),
                                   reps))
    return cells


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=REPO, help="root of the tree whose port is timed")
    parser.add_argument("--label", default=None, help="name of the tree in the output")
    parser.add_argument("--sweep", action="store_true",
                        help="also time every cluster size (a tree with cluster_plan)")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_decode_times: no CUDA device")
    cs = _chip_smoke()
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    if not os.path.abspath(ic.__file__).startswith(tree + os.sep):
        raise SystemExit(f"int8_decode_times: imported {ic.__file__}, not from {tree}")
    power_line = cs.nvidia_smi_line()
    print(f"card: {power_line}", flush=True)
    label = args.label or tree
    dev = torch.device("cuda")
    reps = 20
    for K, N in cs.INT8_SHAPES:
        _, q, scale = cs.int8_inputs(8, K, N, torch.bfloat16, dev, seed=1)
        qs = [q.clone() for _ in range(max(2, int(128e6 // q.numel()) + 1))]
        ws = [w.to(torch.bfloat16) for w in qs[:max(2, int(128e6 // (2 * q.numel())) + 1)]]
        state = {"i": 0}

        def nxt(pool):
            state["i"] += 1
            return pool[state["i"] % len(pool)]

        for M in (8, 40):
            x = cs.int8_inputs(M, K, N, torch.bfloat16, dev, seed=M)[0]
            with torch.no_grad():
                got = ic.int8_matmul_cuda(x, q, scale, torch.bfloat16).float()
                ref = quant.int8_matmul_plain(x.float(), q, scale, torch.float32)
                torch.testing.assert_close(got, ref, rtol=2.0 ** -8,
                                           atol=1e-4 * ref.abs().max().item())
                kernel = lambda: ic.int8_matmul_cuda(x, nxt(qs), scale, torch.bfloat16)
                t_kernel = cs.graph_ms(kernel, reps)
                t_lib = cs.graph_ms(lambda: torch.matmul(x, nxt(ws)), reps)
                t_eager = cs.cuda_ms(kernel, reps)
            b = cs.bound(2.0 * M * K * N, M * K * 2 + K * N + N * 4 + M * N * 2, "bfloat16")
            cell = {"tree": label, "K": K, "N": N, "M": M, "plan": plan_text(ic, M, K, N),
                    "kernel_ms": t_kernel, "matmul_ms": t_lib, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"], "bound_share": b["bound_ms"] / t_kernel,
                    "kernel_over_matmul": t_kernel / t_lib, "eager_ms": t_eager,
                    "max_abs_err": (got - ref).abs().max().item(), "card": power_line}
            if args.sweep:
                cell["by_cluster_size_ms"] = sweep(cs, ic, x, lambda: nxt(qs), scale, reps)
            print(json.dumps(cell), flush=True)
        del qs, ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
