"""Cells are data: adding files (a traffic, its limits, a configuration, an
end-to-end metric's reader, entries in BENCHMARK.json) adds a cell that the
harness runs unchanged, with the reference module, driver and readers found
by name in its own tree; and every
cell's reference agrees with the port's CPU path at debug sizes."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness

CELLS = ["ctc_train", "mlm_train_t1024", "ctc_train_chained", "ctc_train_pooled"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_cpu_path(cell, shrink):
    """In float32 on the CPU the port and the reference differ by rounding
    alone: far under the cell's limits (set for bfloat16 on the card)."""
    r = harness.run(cell, 7 + CELLS.index(cell), 0.3, False, device="cpu", shrink=shrink,
                    log=open(os.devnull, "w"))
    assert r["correct"]
    for name, c in r["checks"].items():
        assert c["value"] <= 1e-5, (name, c)


def test_adding_files_adds_a_cell(tmp_path):
    root = tmp_path
    bench = root / "bench_port"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    traffic = json.load(open(bench / "traffic" / "speechbci_streamed.json"))
    traffic["trainer"]["training"]["metric_lag"] = 1
    traffic["why"] = "the CER read back after every step"
    json.dump(traffic, open(bench / "traffic" / "speechbci_lag1.json", "w"))
    shutil.copy(bench / "configs" / "ndt1_ctc_speechbci.json",
                bench / "configs" / "ndt1_ctc_copy.json")
    shutil.copy(bench / "limits" / "ctc_train.json", bench / "limits" / "ctc_train_lag1.json")
    (bench / "end_to_end" / "window_s.py").write_text(
        "def read(ctx):\n    return ctx.window_s\n")
    spec["configs"].append(dict(spec["configs"][0], name="ndt1_ctc_copy",
                                file="bench_port/configs/ndt1_ctc_copy.json"))
    spec["workloads"].append({"name": "ctc_train_lag1", "config": "ndt1_ctc_copy",
                              "traffic": "speechbci_lag1", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "window_s", "unit": "s", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["ctc_train_lag1"]})
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    code = (
        "import os, sys\n"
        f"sys.path[:0] = [{str(bench)!r}, {str(root)!r}, {harness.ROOT!r}]\n"
        "from conftest import debug_sizes\n"
        "import harness\n"
        "r = harness.run('ctc_train_lag1', 99, 0.3, False, device='cpu', shrink=debug_sizes,"
        " log=open(os.devnull, 'w'))\n"
        "print(sorted(r['metrics']), r['correct'], r['attempted'] > 0,"
        " all(sys.modules[m].__file__.startswith(sys.path[0])"
        " for m in ('reference.ndt1', 'check', 'traffic')))\n")
    shutil.copy(os.path.join(harness.BENCH_DIR, "conftest.py"), bench / "conftest.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == (
        "['peak_mem_gib', 'setup_s', 'train_samples_per_s', 'window_s'] True True True")
