"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry point never falls back to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sir_gcn_tpu"}


def _port_files():
    files = sorted((ROOT / "sir_gcn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]


def test_no_file_of_the_port_imports_jax():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bench_torch\n"
        "import sir_gcn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_trainer_without_cpu_flag_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--epochs", "1", "--nruns", "1",
                     "--synthetic-nodes", "64", "--synthetic-edges", "128"])


BATCHED = ("experiments/batched_harness.py", "experiments/common_models.py",
           "experiments/zinc/train.py", "experiments/zinc/model.py",
           "experiments/ogbg_molhiv/train.py",
           "experiments/ogbg_molhiv/model.py",
           "experiments/ogbg_molhiv/fingerprint.py",
           "experiments/sbm/train.py", "experiments/super_pixel/train.py",
           "data/prefetch.py", "models/encoders.py")


def test_the_batched_workloads_are_in_the_walk():
    """The import walks above reach the batched-graph workloads and the
    layers they brought (each a package module, so walk_packages imports
    it)."""
    files = {p.relative_to(ROOT / "sir_gcn_tpu_torch").as_posix()
             for p in _port_files()[:-2]}
    assert set(BATCHED) <= files
    for rel in BATCHED:
        assert (ROOT / "sir_gcn_tpu_torch" / rel).parent.joinpath(
            "__init__.py").exists(), rel


@pytest.mark.parametrize("name", ["zinc", "ogbg_molhiv", "sbm",
                                  "super_pixel"])
def test_batched_entry_points_need_a_card(monkeypatch, name):
    import importlib

    train = importlib.import_module(
        f"sir_gcn_tpu_torch.experiments.{name}.train")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--epochs", "1", "--nruns", "1", "--nhidden", "4",
                    "--nlayers", "1", "--synthetic-samples", "20"])
