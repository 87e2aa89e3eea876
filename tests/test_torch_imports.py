"""oscen_tpu_torch never imports jax: with ``sys.modules["jax"] = None``
(any ``import jax`` then raises) the package imports, and the electric
piano builds, compiles and renders a block on the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_and_renders_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import oscen_tpu_torch
        from oscen_tpu_torch import raw_midi_event
        from oscen_tpu_torch.models.electric_piano import (
            build_electric_piano)
        from oscen_tpu_torch.utils import convert  # noqa: F401
        p = build_electric_piano(4).compile(48000.0, block_size=64)
        p.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
        a = p.process_block()["out"]
        b = p.process_block()["out"]
        assert a.shape == b.shape == (64, 2)
        assert float(b.abs().max()) > 0.01
        assert sys.modules["jax"] is None
        assert not any(m.startswith("oscen_tpu.") or m == "oscen_tpu"
                       for m in sys.modules)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
