"""K16 row delivery (``tools/kabl2.py``) on the CPU: the plain versions of
``oscen_tpu_torch/ops/cuda/kabl.py`` against the tool's Pallas kernel in
interpret mode, one case per variant, at the bounds
``tests/test_torch_kabl.py`` states.

kabl2's one-hot table is random here (the tool passes zeros), so that the
one-hot rows are not all zero; the tool's kernel and the port get the same
bf16 values.
"""

import pytest

from oscen_tpu_torch.ops.cuda import kabl as tk
from test_torch_kabl import check_variant


@pytest.mark.parametrize("variant", list(tk.TOOLS["kabl2"]))
def test_kabl2_matches_pallas_interpret(variant):
    # dot4 keeps acc[:4 SUB] of 2B / 4 rows: B >= 256
    B = 256 if variant == "dot4" else 128
    check_variant("kabl2", variant, B=B, tbl_rows=4 * B)


@pytest.mark.parametrize("tool", ["kabl", "kabl2", "kabl3", "kabl4", "kabl5",
                                  "kabl6"])
def test_driver_parity_line_on_the_cpu(tool, capsys):
    """Each driver builds its tool's inputs at full width and prints one
    parity line per variant (the baseline at 0 from itself)."""
    import importlib
    mod = importlib.import_module(f"oscen_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(f"[{tool}] ") and "against" in ln]
    assert len(lines) == len(tk.TOOLS[tool])
    assert any("max abs 0.000e+00" in ln for ln in lines)
