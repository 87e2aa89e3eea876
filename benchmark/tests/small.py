"""A copy of the benchmark's data at a size a CPU test run can hold: the
same cells, mixes and metrics, each configuration at ``voices`` voices and
each mix with a warm-up of a few blocks."""

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small_root(tmp: Path, voices: int = 8) -> Path:
    data = tmp / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, data / sub)
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for p in (data / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["voices"] = voices
        cfg["builder_args"]["num_voices"] = voices
        p.write_text(json.dumps(cfg))
    for p in (data / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix["warmup_s"] = min(mix.get("warmup_s", 0.0), 0.1)
        p.write_text(json.dumps(mix))
    return tmp
