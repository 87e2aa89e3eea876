"""K12's share of its roofline in a steady block of the FM synth: the least
time of three operators' wrapped phases (``roofline.share``) over the
profiler time of its launches."""

from benchmark.roofline import F32, share

NAMES = ("fract_phase3_kernel",)


def work(V: int, B: int):
    """One block: phases and increments ``[3, V]`` in, the phases before
    each step ``[3, B, V]`` and the carry out; 9 operations a sample step
    of each voice."""
    return 9 * B * V, F32 * (3 * B * V + 3 * 3 * V)


def read(run):
    return share(run, NAMES, work)
