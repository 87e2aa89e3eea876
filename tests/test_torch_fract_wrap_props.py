"""K12's per-lane short wrap on hypothesis-drawn float32 bit patterns of
(p0, dt): the model of ``tests/test_torch_fract_wrap.py`` held bit for bit
to ``plain_fract_phase3``.  Skipped where hypothesis is not installed; the
edge, mixed-lane and stride cases there run without it.
"""

import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_fract_wrap import (_from_bits, _in_unit,  # noqa: E402
                                   _same_bits, model_fract_phase3)

from oscen_tpu_torch.ops.cuda import fm as tfm  # noqa: E402

_PATTERN = st.integers(min_value=0, max_value=2 ** 32 - 1)


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(st.tuples(_PATTERN, _PATTERN), min_size=1, max_size=12))
def test_any_patterns_equal_the_plain_version(lanes):
    """Any float32 patterns of (p0, dt), a lane each, 2 chained blocks."""
    p = _from_bits([a for a, _ in lanes]).expand(3, -1).contiguous()
    dt = _from_bits([b for _, b in lanes]).expand(3, -1).contiguous()
    for _ in range(2):
        got, _ = model_fract_phase3(p, dt, 40)
        assert _same_bits(got, tfm.plain_fract_phase3(p, dt, 40))
        p = got[3]


@settings(max_examples=100, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 0x3F7FFFFF),
                          st.integers(0, 0x3F7FFFFF)),
                min_size=1, max_size=12))
def test_unit_patterns_take_the_short_wrap(lanes):
    """Patterns of [+0, 1) for both: every lane takes the short wrap, and
    its phases stay in [+0, 1) (the model asserts q in [+0, 2))."""
    p = _from_bits([a for a, _ in lanes]).expand(3, -1).contiguous()
    dt = _from_bits([b for _, b in lanes]).expand(3, -1).contiguous()
    got, short = model_fract_phase3(p, dt, 200)
    assert bool(short.all())
    assert _same_bits(got, tfm.plain_fract_phase3(p, dt, 200))
    assert bool(_in_unit(got[3]).all())
