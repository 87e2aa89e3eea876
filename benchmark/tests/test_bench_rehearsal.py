"""The whole run on the CPU at a small size, in a subprocess (the test
session itself has JAX loaded by the repository's pytest plugin): it ends
with a result whose numbers stand under ``cpu_`` names only, and neither
the harness, the reference nor the program loads JAX or the JAX package;
without a card and without ``--rehearse`` it prints no result."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.small import HERE, small_root

FORBIDDEN = {"jax", "jaxlib", "flax", "oscen_tpu"}
PROBE = """
import json, sys
from benchmark import run
from benchmark.reference import epiano, fm, midi  # noqa: F401
rc = run.main(sys.argv[1:])
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"rc": rc, "modules": tops}))
"""


def rehearse(root, cell, trace, seed=31):
    p = subprocess.run(
        [sys.executable, "-c", PROBE, "--workload", cell, "--seed",
         str(seed), "--seconds", "0.5", "--trace", str(trace), "--rehearse",
         "--root", str(root)],
        cwd=HERE.parent, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), p.stderr


@pytest.mark.parametrize("cell,trace", [("epiano256.held.b1024", 0),
                                        ("fm256.held.b1024", 1)])
def test_cpu_rehearsal_loads_no_jax_and_names_no_card_metric(
        tmp_path, cell, trace):
    root = small_root(tmp_path)
    result, probe, err = rehearse(root, cell, trace)
    assert probe["rc"] == 0
    assert not FORBIDDEN & set(probe["modules"]), probe["modules"]
    assert "oscen_tpu_torch" in probe["modules"]
    assert result["correct"] is True, err[-2000:]
    assert result["device"]["platform"] == "cpu"
    assert result["metrics"], result
    assert all(k.startswith("cpu_") for k in result["metrics"])
    assert list(result)[-1] == "checked"
    assert err.rstrip().splitlines()[-1].startswith("checked ")


def test_no_card_no_result(tmp_path):
    root = small_root(tmp_path)
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "epiano256.held.b1024", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--root", str(root)],
        cwd=HERE.parent, capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_the_benchmark_alone_is_no_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the program is missing: no result."""
    import shutil
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "epiano256.held.b1024", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
