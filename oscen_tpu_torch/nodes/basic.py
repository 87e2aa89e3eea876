"""Small utility nodes.

Counterpart of ``oscen_tpu/nodes/basic.py``: Gain (gain/mod.rs), Vca
(examples/pivot/src/vca.rs), Value (value.rs), AudioInput
(graph/audio_input.rs), the fm-synth example's Mixer, Crossfade and
AddValue (examples/fm-synth/src/nodes/), MulAdd, Tremolo
(examples/electric-piano/src/tremolo.rs) and FmOperator
(examples/fm-synth/src/nodes/fm_operator.rs), and HardClip (the
oversampled saturator's nonlinearity).  Tremolo implements the
stream-epilogue fusion hook (``kernel_epilogue``; the block compiler uses
it under ``OSCEN_EPILOGUE_FUSION=1``, default off as in the JAX package).

The stateless nodes broadcast: they take a leading instance axis
(``BATCHED``), so a node array is one call.  Every node has the JAX
package's per-sample ``tick``, in the op order of its block path.
"""

from __future__ import annotations

import torch

from ..core.types import Kind, SampleRate, stream, value
from ..graph.node import Node
from ..ops import fmath
from ..ops.cuda.additive import K_REBASE, TAU, tremolo_pan
from ..ops.fastmath import sin_turns
from ..ops.cuda.fm import fm_operator_scan


class _StatelessNode(Node):
    """Nodes whose output is a pure function of their inputs: the tick's
    math, applied to one sample or to whole ``[(C,) B]`` blocks."""

    BATCHED = True

    def init_state(self, sr: SampleRate):
        return {}

    def process_block(self, state, ins, events, sr, block_len):
        return self.tick(state, ins, sr)

    def const_out_eps(self, const_ins, literal_ins):
        """Const-output propagation (graph/block_mode.py ``const_outs``): a
        pure function of block-constant inputs is block-constant."""
        if all(e.name in const_ins for e in self.INPUTS
               if e.kind not in (Kind.EVENT, Kind.ASSET)):
            return tuple(o.name for o in self.OUTPUTS)
        return ()


def _broadcast_shape(*xs):
    return torch.broadcast_shapes(*[x.shape for x in xs])


class Gain(_StatelessNode):
    """``out = in * gain`` (reference gain/mod.rs)."""

    def __init__(self, initial_gain: float = 1.0):
        self.INPUTS = (stream("input", 0.0),
                       stream("gain", float(initial_gain)))
        self.OUTPUTS = (stream("output"),)

    def const_out_eps(self, const_ins, literal_ins):
        """With a literal 0.0 gain the output is identically zero whatever
        the stream input (the fm/pivot voices feed filter_env_gain a
        0.0-default amount: the envelope modulation folds away until the
        parameter is first set)."""
        if literal_ins.get("gain") == 0.0:
            return ("output",)
        return super().const_out_eps(const_ins, literal_ins)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] * ins["gain"]}

    def process_block(self, state, ins, events, sr, block_len,
                      literal_ins=None):
        if literal_ins and literal_ins.get("gain") == 0.0:
            # in*0 is 0 for the finite inputs the graph produces
            return state, {"output": torch.zeros(
                _broadcast_shape(ins["input"], ins["gain"]),
                dtype=torch.float32, device=ins["input"].device)}
        return self.tick(state, ins, sr)


class Vca(_StatelessNode):
    """Voltage-controlled amplifier: ``out = in * control`` (stream ×
    stream; reference examples/pivot/src/vca.rs:31-36)."""

    INPUTS = (stream("input", 0.0), stream("control", 1.0))
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] * ins["control"]}


class Value(_StatelessNode):
    """Pass-through parameter holder (reference value.rs)."""

    def __init__(self, initial_value: float = 0.0):
        self.INPUTS = (value("input", float(initial_value)),)
        self.OUTPUTS = (value("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"]}


class AudioInput(_StatelessNode):
    """value→stream bridge (reference graph/audio_input.rs)."""

    INPUTS = (value("input_value", 0.0),)
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input_value"]}


class HardClip(_StatelessNode):
    """Drive-then-clip nonlinearity (reference oversampled-saturator
    main.rs:31-62): ``out = clamp(in * 1.5, -0.7, 0.7)``."""

    INPUTS = (stream("input", 0.0),)
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": torch.clamp(ins["input"] * 1.5, -0.7, 0.7)}


class Mixer(_StatelessNode):
    """Two-input adder (reference fm-synth nodes/mixer.rs)."""

    INPUTS = (stream("input_a", 0.0), stream("input_b", 0.0))
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input_a"] + ins["input_b"]}


class Crossfade(_StatelessNode):
    """Splits the input between two outputs by ``mix`` (fm-synth
    nodes/crossfade.rs): ``a = in*(1-mix)``, ``b = in*mix``."""

    INPUTS = (stream("input", 0.0), value("mix", 0.0))
    OUTPUTS = (stream("output_a"), stream("output_b"))

    def tick(self, state, ins, sr):
        mix = torch.clamp(ins["mix"], 0.0, 1.0)
        return state, {"output_a": ins["input"] * (1.0 - mix),
                       "output_b": ins["input"] * mix}


class AddValue(_StatelessNode):
    """``out = in + value`` (fm-synth nodes/add_value.rs)."""

    def __init__(self, v: float = 0.0):
        self.INPUTS = (stream("input", 0.0), value("value", float(v)))
        self.OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] + ins["value"]}


class MulAdd(_StatelessNode):
    """``out = in*gain + value``: a Gain → AddValue pair in one node, the
    same float32 ops in the same order (the fused pivot voice's
    filter-envelope cutoff modulation, pivot_voice.rs:126-130)."""

    def __init__(self, gain: float = 1.0, v: float = 0.0):
        self.INPUTS = (stream("input", 0.0), value("gain", float(gain)),
                       value("value", float(v)))
        self.OUTPUTS = (stream("output"),)

    def const_out_eps(self, const_ins, literal_ins):
        """With a literal 0.0 gain the stream input is multiplied out, so
        the output is block-constant whenever ``value`` is."""
        if literal_ins.get("gain") == 0.0 and "value" in const_ins:
            return ("output",)
        return super().const_out_eps(const_ins, literal_ins)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] * ins["gain"] + ins["value"]}

    def process_block(self, state, ins, events, sr, block_len,
                      literal_ins=None):
        v = ins["value"]
        if literal_ins and literal_ins.get("gain") == 0.0:
            # in*0 + value is value for the finite inputs the graph makes
            return state, {"output": torch.broadcast_to(
                v, _broadcast_shape(ins["input"], v))}
        return self.tick(state, ins, sr)


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

    K_REBASE = K_REBASE  # dt·k stays exact well below 2^24

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

    def tick(self, state, ins, sr):
        """One sample of the anchored LFO (the JAX tick): rebase on a rate
        change, the pan at ``wrap(anchor + dt*k)``, then the count and its
        fixed rebase at K_REBASE."""
        dt = fmath.div(ins["rate"], sr.hz)
        anchor, k = self._rebase(state["anchor"], state["k"],
                                 state["dt_last"], dt)
        phase = self._wrap(anchor + dt * k.to(torch.float32))
        out = self._pan(ins["input"], phase, ins["depth"])
        k = k + 1
        rebase = k >= self.K_REBASE
        anchor = torch.where(
            rebase, self._wrap(anchor + dt * float(self.K_REBASE)), anchor)
        k = torch.where(rebase, k - self.K_REBASE, k)
        return {"anchor": anchor, "k": k, "dt_last": dt}, {"output": out}

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

    def kernel_epilogue(self, state, vals, sr, block_len):
        """Stream-epilogue fusion protocol (graph/block_mode.py): when this
        node's only stream input is a producer's fused voice mix-down and
        its value inputs are block-constant, the producer's kernel runs the
        per-sample pan after its mix.  ``vals`` holds the value inputs as
        0-dim tensors.  Returns ``(C, fn, params, new_state)``: the channel
        count, the pan (the kernel's, see ops/cuda/additive.py
        ``tremolo_pan``), its ``[anchor, k0, dt, depth, a2]`` and the state
        after the block, advanced here in closed form with the arithmetic
        of :meth:`process_block`."""
        dt0 = fmath.div(vals["rate"], sr.hz)
        K = float(self.K_REBASE)
        anchor, k0 = self._rebase(state["anchor"], state["k"],
                                  state["dt_last"], dt0)
        a2 = self._wrap(anchor + dt0 * K)
        k_end = k0 + block_len
        reb = k_end >= self.K_REBASE
        new_state = {"anchor": torch.where(reb, a2, anchor),
                     "k": torch.where(reb, k_end - self.K_REBASE, k_end),
                     "dt_last": dt0}
        params = torch.stack([anchor, k0.to(torch.float32), dt0,
                              vals["depth"].to(torch.float32), a2])
        return 2, Tremolo._epilogue_fn, params, new_state

    # the per-sample pan of the mix at ticks t0.. (mix [U], params
    # [anchor, k0, dt, depth, a2]) -> the two channel columns
    _epilogue_fn = staticmethod(tremolo_pan)

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


class FmOperator(Node):
    """Sine operator with phase modulation and self-feedback (reference
    examples/fm-synth/src/nodes/fm_operator.rs).

    The feedback (``prev_output * feedback`` into the phase) is a
    one-sample nonlinear recurrence: the block path is one
    ``fm_operator_scan`` over all instances (the kernel on the card), in
    the tick's op order ``sin_turns(phase + (pm + prev*fb)) * env * lvl``
    with the ``.fract()`` wrap.  It takes a leading instance axis
    (``BATCHED``): state ``[C]``, inputs ``[C, B]``.
    """

    INPUTS = (value("base_freq", 440.0), value("ratio", 1.0),
              stream("phase_mod", 0.0), value("feedback", 0.0),
              stream("envelope", 1.0), value("level", 1.0))
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def init_state(self, sr: SampleRate):
        return {"phase": torch.tensor(0.0, dtype=torch.float32),
                "prev_output": torch.tensor(0.0, dtype=torch.float32)}

    def tick(self, state, ins, sr):
        """One sample in the kernel's op order: ``sin_turns(phase + (pm +
        prev*fb)) * env * lvl``, then the phase step and its ``.fract()``
        wrap."""
        total_pm = ins["phase_mod"] + state["prev_output"] * ins["feedback"]
        out = sin_turns(state["phase"] + total_pm) * ins["envelope"] \
            * ins["level"]
        phase = state["phase"] + fmath.div_const(
            ins["base_freq"] * ins["ratio"], sr.hz)
        return ({"phase": phase - torch.trunc(phase), "prev_output": out},
                {"output": out})

    def process_block(self, state, ins, events, sr, block_len):
        # base_freq*ratio/sr as XLA compiles it in the JAX package's graph
        dt = fmath.div_const(ins["base_freq"] * ins["ratio"], sr.hz)

        def tbv(v):   # [C, B] -> [B, C]
            return v.t().contiguous()
        y, phase, prev = fm_operator_scan(
            state["phase"].contiguous(), state["prev_output"].contiguous(),
            tbv(dt), tbv(ins["phase_mod"]), tbv(ins["feedback"]),
            tbv(ins["envelope"]), tbv(ins["level"]))
        return ({"phase": phase, "prev_output": prev},
                {"output": y.t()})

    def process_block_batched(self, state, ins, events, sr, block_len):
        """All instances through the one kernel call (the JAX package's
        batched path)."""
        return self.process_block(state, ins, events, sr, block_len)
