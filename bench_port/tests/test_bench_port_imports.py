"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "llm_bci_tpu"}


def imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def python_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_in_the_benchmark_sources():
    for path in python_files(harness.BENCH_DIR):
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in python_files(os.path.join(harness.BENCH_DIR, "reference")):
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert "llm_bci_tpu_torch" not in tops and not tops & FORBIDDEN, path


def test_a_run_loads_no_jax(shrink):
    code = (
        "import os, sys; sys.path[:0] = ['bench_port', '.']\n"
        "from conftest import debug_sizes\n"
        "import harness\n"
        "r = harness.run('mlm_train_t1024', 5, 0.2, False, device='cpu', shrink=debug_sizes,"
        " log=open(os.devnull, 'w'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(r['forbidden_modules'])\n")
    root = os.path.dirname(harness.BENCH_DIR)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = eval(proc.stdout.strip().splitlines()[-2])
    assert not set(loaded) & FORBIDDEN and "llm_bci_tpu_torch" in loaded
    assert proc.stdout.strip().splitlines()[-1] == "[]"
