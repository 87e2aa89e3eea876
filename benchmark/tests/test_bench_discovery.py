"""A cell, configuration, traffic mix or per-layer metric is added with new
files and ``BENCHMARK.json`` entries alone: the harness finds each by its
name, and no file that is there changes."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmark.cell import load

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def digests(d: Path):
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()}


def copy_data(tmp: Path) -> Path:
    data = tmp / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, data / sub)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return data


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load(ROOT, w["name"])
        assert cell.readers and len(cell.end_to_end) >= 2
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        for m in cell.per_layer:
            assert hasattr(cell.readers[m["name"]], "read")


def test_new_files_are_found_with_no_edit(tmp_path):
    data = copy_data(tmp_path)
    before = digests(data)
    # a new configuration, mix and metric, each a file of its own
    cfg = json.loads((data / "configs" / "epiano256.json").read_text())
    cfg.update(voices=64, builder_args={"num_voices": 64, "fused": True})
    (data / "configs" / "epiano64.json").write_text(json.dumps(cfg))
    mix = json.loads((data / "traffic" / "perform.json").read_text())
    mix.update(note_ons_per_s=40.0)
    (data / "traffic" / "sparse.json").write_text(json.dumps(mix))
    (data / "metrics" / "host.blocks.sparse.py").write_text(
        "def read(run):\n    return float(run.blocks)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "epiano64", "source": "x",
                             "file": "benchmark/configs/epiano64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "epiano64.sparse.b1024",
                               "config": "epiano64", "traffic": "sparse",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "host.blocks.sparse", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "control plane and staging",
                               "moves": "rtf",
                               "workloads": ["epiano64.sparse.b1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load(tmp_path, "epiano64.sparse.b1024")
    assert cell.config["voices"] == 64
    assert cell.mix["note_ons_per_s"] == 40.0
    assert set(cell.readers) == {"host.blocks.sparse"}

    class R:
        blocks = 7
    assert cell.readers["host.blocks.sparse"].read(R) == 7.0
    after = digests(data)
    assert {k: v for k, v in after.items() if k in before} == before
    # and the cells that were there still load as they did
    assert load(tmp_path, "epiano256.held.b1024").config["voices"] == 256


def test_a_metric_without_workloads_goes_to_every_cell_of_its_metric(
        tmp_path):
    copy_data(tmp_path)
    (tmp_path / "benchmark" / "metrics" / "any.rtf.py").write_text(
        "def read(run):\n    return None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "any.rtf", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "rtf"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for w in bench["workloads"]:
        assert "any.rtf" in load(tmp_path, w["name"]).readers
