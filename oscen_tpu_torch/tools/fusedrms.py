"""The fused additive kernel's distance from the exact op order on the
bench config: 256 voices at 48 kHz, the bench chord struck and held.

Counterpart of the v4-against-parity part of the JAX package's
``tools/fusedrms.py``.  The chord renders through K1 (``v4``, the
closed-form subgroups) and through K2 (``parity``, the reference's
per-sample op order) on the same device, with the same events and the
same block size; the line gives the RMS, max abs and relative RMS of the
difference over the whole render and for each second of audio.  The
chord's own block runs the composed closed forms under both versions; the
steady blocks after it run the kernel (on the CPU, its plain version).
The JAX tool's ``OSCEN_ADDITIVE_SUB`` sweep has no counterpart: the port
has no such switch.

The bound is the JAX package's fused-path bound, v4 at 5e-4 RMS from the
exact op order at 4 voices (``tests/test_electric_piano.py``), scaled by
sqrt(V / 4) for the V voices' mix, as PERF.md (section 2) scales the
block-against-sample bound.

Usage: python -m oscen_tpu_torch.tools.fusedrms [--voices=256]
    [--block=1024] [--seconds=2] [--device=cpu]

The last line of the output is one JSON object (``cpu_`` before the
metric name of a CPU run).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

SR = 48_000.0
RMS_AT_4 = 5e-4     # v4 against the exact op order at 4 voices


def rms_bound(voices: int) -> float:
    return RMS_AT_4 * math.sqrt(voices / 4)


def render(version: str, voices: int, block: int, seconds: float,
           device: str) -> np.ndarray:
    """The held chord through additive kernel ``version``: the chord's
    block, then ``seconds`` of steady blocks; ``[frames, 2]``."""
    import torch

    from ..bench import strike_chord
    from ..models.electric_piano import build_electric_piano
    saved = {k: os.environ.get(k) for k in ("OSCEN_ADDITIVE_KERNEL",
                                            "OSCEN_EPILOGUE_FUSION")}
    os.environ["OSCEN_ADDITIVE_KERNEL"] = version
    os.environ["OSCEN_EPILOGUE_FUSION"] = "0"
    try:
        p = build_electric_piano(voices).compile(SR, block_size=block,
                                                 mode="block", device=device)
        strike_chord(p, voices)
        p.process_block()
        n_blocks = max(1, int(seconds * SR / block))
        out = [p.process_block()["out"] for _ in range(n_blocks)]
        return torch.cat(out).cpu().numpy()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    d = got - ref
    rms = float(np.sqrt(np.mean(d ** 2)))
    return {"rms": rms, "max_abs": float(np.max(np.abs(d))),
            "rel_rms": rms / float(np.sqrt(np.mean(ref ** 2)))}


def measure(voices: int = 256, block: int = 1024, seconds: float = 2.0,
            device: str = "cuda") -> dict:
    """v4 against parity on ``device``: the whole render and each second;
    the kernels' launches (0 on the CPU, where the plain versions run)."""
    from ..ops.cuda import additive
    launches = {}
    outs = {}
    for version in ("parity", "v4"):
        before = additive.launches[version]
        outs[version] = render(version, voices, block, seconds, device)
        launches[version] = additive.launches[version] - before
    got, ref = outs["v4"], outs["parity"]
    sec = int(SR)
    per_second = [compare(got[i:i + sec], ref[i:i + sec])
                  for i in range(0, ref.shape[0], sec)]
    if device == "cpu":
        name = "cpu"
    else:
        import torch
        name = torch.cuda.get_device_name(0)
    return {"metric": f"{'cpu_' if device == 'cpu' else ''}electric_piano_"
                      f"{voices}v_v4_vs_parity",
            **compare(got, ref), "bound_rms": rms_bound(voices),
            "signal_rms": float(np.sqrt(np.mean(ref ** 2))),
            "per_second": per_second, "voices": voices, "block": block,
            "seconds": ref.shape[0] / SR, "launches": launches,
            "device": name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m oscen_tpu_torch.tools.fusedrms",
        description="K1 (v4) against K2 (parity) on the bench chord.")
    ap.add_argument("--voices", type=int, default=256)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("fusedrms: torch sees no CUDA card (--device cpu runs the "
                  "plain versions)", file=sys.stderr)
            return 2
    r = measure(a.voices, a.block, a.seconds, a.device)
    print(f"# config: {a.voices}v B={a.block} {r['seconds']:.3f} s chord on "
          f"{r['device']}; signal RMS {r['signal_rms']:.4g}; launches "
          f"{r['launches']}", flush=True)
    for i, s in enumerate(r["per_second"]):
        print(f"second {i}: v4 vs parity rms={s['rms']:.3e} "
              f"({s['rel_rms']:.3e} rel) max_abs={s['max_abs']:.3e}",
              flush=True)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
