"""Small utility nodes.

Counterpart of ``oscen_tpu/nodes/basic.py``; the port has ``Tremolo``
(examples/electric-piano/src/tremolo.rs), the stereo stage of the electric
piano.  The JAX package's stream-epilogue fusion hook (``kernel_epilogue``,
default off there) is not ported.
"""

from __future__ import annotations

import math

import torch

from ..core.types import SampleRate, stream, value
from ..graph.node import Node
from ..ops import fmath

TAU = 2.0 * math.pi


class Tremolo(Node):
    """Mono→stereo constant-power pan LFO (reference
    examples/electric-piano/src/tremolo.rs:8-60).

    The LFO phase is *anchored*: ``phase(t) = wrap(anchor + dt·k)`` with the
    integer tick count ``k`` carried and the anchor rebased only when the
    rate changes (or at a fixed absolute K_REBASE to keep ``dt·k`` exact in
    f32).  The block path evaluates that formula vectorized, so it is
    block-size invariant.
    """

    INPUTS = (stream("input", 0.0), value("rate", 5.0), value("depth", 0.5))
    OUTPUTS = (stream("output", channels=2),)

    K_REBASE = 1 << 20  # dt·k stays exact well below 2^24

    def init_state(self, sr: SampleRate):
        return {"anchor": torch.tensor(0.0, dtype=torch.float32),
                "k": torch.tensor(0, dtype=torch.int32),
                "dt_last": torch.tensor(0.0, dtype=torch.float32)}

    @staticmethod
    def _wrap(p):
        return p - torch.floor(p)

    @staticmethod
    def _pan(x, phase, depth):
        lfo = fmath.sin(phase * TAU)
        pan = 0.5 + lfo * fmath.div(depth, 3.0)
        return torch.stack([x * pan, x * (1.0 - pan)], dim=-1)

    def _rebase(self, anchor, k, dt_last, dt):
        """A rate change at this tick restarts the count from the phase
        reached so far."""
        changed = torch.logical_and(dt != dt_last, k > 0)
        anchor = torch.where(
            changed, self._wrap(anchor + dt_last * k.to(torch.float32)),
            anchor)
        return anchor, torch.where(changed, torch.zeros_like(k), k)

    def process_block(self, state, ins, events, sr, block_len,
                      const_ins=frozenset()):
        B = block_len
        dt = fmath.div(ins["rate"], sr.hz)  # [B]
        if "rate" not in const_ins:
            return self._process_varying(state, ins, dt)
        # rate is block-constant: the only possible change is at the block
        # boundary, so rebase once and evaluate the anchored closed form
        # (the JAX package's "const" form; its default cond form takes the
        # same arithmetic whenever the rate is constant over the block)
        K = float(self.K_REBASE)
        dt0 = dt[0]
        anchor, k0 = self._rebase(state["anchor"], state["k"],
                                  state["dt_last"], dt0)
        ks = k0.to(torch.float32) + torch.arange(
            B, dtype=torch.float32, device=dt.device)
        a2 = self._wrap(anchor + dt0 * K)
        phase = torch.where(ks < K, self._wrap(anchor + dt0 * ks),
                            self._wrap(a2 + dt0 * (ks - K)))
        k_end = k0 + B
        reb = k_end >= self.K_REBASE
        new_state = {"anchor": torch.where(reb, a2, anchor),
                     "k": torch.where(reb, k_end - self.K_REBASE, k_end),
                     "dt_last": dt0}
        return new_state, {"output": self._pan(ins["input"], phase,
                                               ins["depth"])}

    def _process_varying(self, state, ins, dt):
        """Per-sample rate (a ramping parameter): the tick recurrence,
        sample by sample."""
        anchor, k, dt_last = state["anchor"], state["k"], state["dt_last"]
        K = float(self.K_REBASE)
        phases = []
        for t in range(dt.shape[0]):
            dt_t = dt[t]
            anchor, k = self._rebase(anchor, k, dt_last, dt_t)
            phases.append(self._wrap(anchor + dt_t * k.to(torch.float32)))
            k = k + 1
            rebase = k >= self.K_REBASE
            anchor = torch.where(rebase, self._wrap(anchor + dt_t * K),
                                 anchor)
            k = torch.where(rebase, k - self.K_REBASE, k)
            dt_last = dt_t
        phase = torch.stack(phases)
        return ({"anchor": anchor, "k": k, "dt_last": dt_last},
                {"output": self._pan(ins["input"], phase, ins["depth"])})
