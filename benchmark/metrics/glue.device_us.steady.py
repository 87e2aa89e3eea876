"""The block function's node glue on the card: profiler device time a
block in PyTorch's own kernels and copies (``readers.is_glue``: ATen's
kernel names, copies and fills), that is, everything but the program's
hand-written kernels."""

from benchmark.readers import glue_us as read  # noqa: F401
