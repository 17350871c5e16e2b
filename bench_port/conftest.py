"""Test settings of the benchmark's own tests (``bench_port/tests``): the
benchmark's modules on the path, the ``card`` marker (tests that need a CUDA
card; each decides inside the test and skips without one), and the debug
sizes at which the CPU tests run a cell."""
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(BENCH_DIR), BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def debug_sizes(config, traffic):
    """A cell cut to a size the CPU runs in seconds: one layer of 32, 16
    trials of a few dozen bins, batches of 4, float32."""
    t = config["trainer"]
    t["model"]["encoder"]["transformer"].update(n_layers=1, hidden_size=32, inter_size=32,
                                                n_heads=2)
    emb = t["model"]["encoder"]["embedder"]
    emb.update(input_dim=16, max_F=128)
    if emb["stack"]["active"]:
        emb["stack"].update(size=8, stride=4)
        traffic["bins"] = [[40, 48, 1.0]]
    else:
        traffic["bins"] = [[24, 32, 1.0]]
    for f in traffic["features"]:
        f["channels"] = 16 // len(traffic["features"])
    t["training"]["train_batch_size"] = 4
    t["precision"]["compute_dtype"] = "float32"
    config["train_trials"], config["test_trials"] = 16, 4
    traffic["run"]["trace_steps"] = 4
    if traffic["trainer"]["training"].get("cache_device_batches"):
        traffic["run"].update(warmup_steps=8, follow_step=6)


@pytest.fixture
def shrink():
    return debug_sizes
