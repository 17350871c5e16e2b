"""The result line: its keys, the traced run's breakdown, a failed metric's
key, and the harness's refusals (no card; no program beside it)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness

ROOT = os.path.dirname(harness.BENCH_DIR)
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_is_one_json_line(trace, shrink):
    r = harness.run("ctc_train_chained", 2**31 + 12345, 0.5, bool(trace), device="cpu",
                    shrink=shrink, log=open(os.devnull, "w"))
    r.pop("forbidden_modules")
    line = json.dumps(r)
    assert "\n" not in line and json.loads(line) == r
    assert KEYS <= set(r) and list(r)[-1] == "checks"
    assert ("breakdown" in r) == bool(trace)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    spec = harness.cell_spec("ctc_train_chained")
    want = spec["per_layer" if trace else "end_to_end"]
    assert set(r["metrics"]) <= {m["name"] for m in want}
    for m in r["metrics"].values():
        assert set(m) >= {"value", "unit"}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    for k, v in r["checks"].items():
        assert set(v) == {"value", "limit"}


class _Empty:
    stretch = None
    stretch_batches = []
    unprofiled_batches = []
    unprofiled_s = None


class _Broken:
    unprofiled_batches = [{}]
    unprofiled_s = 1.0
    stretch_batches = [{}]
    stretch = None


@pytest.mark.parametrize("folder,name", [("metrics", "step_mfu"),
                                         ("end_to_end", "train_samples_per_s")])
def test_failed_metric_keeps_its_key(folder, name):
    out = harness.read_metrics(folder, [{"name": name, "unit": "x"}], _Broken())
    assert out[name]["value"] is None and "error" in out[name]


def test_metrics_that_find_nothing_are_left_out():
    specs = [{"name": "step_mfu", "unit": "%"}, {"name": "flash_roofline", "unit": "%"},
             {"name": "device_idle_share", "unit": "%"}]
    assert harness.read_metrics("metrics", specs, _Empty()) == {}


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "ctc_train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys; sys.path[:0] = ['bench_port']; import harness; "
            "print(harness.run('ctc_train', 1, 0.1, False, device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, env={k: v for k, v in os.environ.items()
                                          if k != "PYTHONPATH"})
    assert proc.returncode != 0 and "llm_bci_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "ctc_train",
                           "--seed", "2147483659", "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert KEYS <= set(r) and r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
