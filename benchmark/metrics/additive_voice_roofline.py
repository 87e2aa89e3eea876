"""K1's share of its roofline in a steady block of the piano: the least
time of the 32-harmonic voice bank and its mix (``roofline.share``) over
the profiler time of the launches of the kernels that implement it."""

from benchmark.roofline import F32, share

NAMES = ("additive_closed_kernel", "additive_parity_kernel")
H = 32                     # the piano voice's harmonics
PAN_OPS = 11               # the tremolo's pan, once a mix sample


def work(V: int, B: int):
    """One block: the seven ``[H, V]`` state and parameter planes and the
    steps in, the four state planes and the steps out, the stereo mix out;
    21 operations a sample step of each (harmonic, voice) lane and the
    pan's 11 a sample."""
    nbytes = F32 * ((7 + 4) * H * V + 2 * V + 2 * B)
    return 21 * B * H * V + PAN_OPS * B, nbytes


def read(run):
    return share(run, NAMES, work)
