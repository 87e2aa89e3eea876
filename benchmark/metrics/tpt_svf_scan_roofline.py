"""K7's share of its roofline in a steady block of the FM synth: the least
time of the voices' lowpass scan (``roofline.share``) over the profiler
time of its launches."""

from benchmark.roofline import F32, share

NAMES = ("tpt_svf_kernel",)


def work(V: int, B: int):
    """One block: the input and output ``[B, V]``, the hoisted coefficients
    ``[3, V]`` and the two integrators in and out; 12 operations a sample
    step of each voice."""
    return 12 * B * V, F32 * (2 * B * V + 3 * V + 4 * V)


def read(run):
    return share(run, NAMES, work)
