"""K16 attribution at the production config (``tools/kabl4.py``) on the
CPU: the plain versions of ``oscen_tpu_torch/ops/cuda/kabl.py`` against
the tool's Pallas kernel in interpret mode, one case per variant, at the
bounds ``tests/test_torch_kabl.py`` states.  defmix halves the voices down
to 128 columns: V = 128.
"""

import pytest

from oscen_tpu_torch.ops.cuda import kabl as tk
from test_torch_kabl import check_variant


@pytest.mark.parametrize("variant", list(tk.TOOLS["kabl4"]))
def test_kabl4_matches_pallas_interpret(variant):
    check_variant("kabl4", variant)
