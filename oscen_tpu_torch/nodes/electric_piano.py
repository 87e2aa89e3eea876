"""Electric-piano voice nodes.

Counterpart of ``oscen_tpu/nodes/electric_piano.py``: the reference
example's additive voice (examples/electric-piano/src/
electric_piano_voice.rs).

- :class:`OscillatorBank` — 32 sine harmonics via complex rotation
  (:79-170).  The block path closes the rotation into powers of the
  per-harmonic multiplier, read from split power tables.
- :class:`AmplitudeSource` — per-harmonic decay/release envelopes updated
  every 64 samples with linear interpolation between updates (:173-356),
  in the closed form ``C0 * m^n * (1 - (j/64)(1-m))`` over the 65-tick
  cycle.
- :class:`ElectricPianoVoice` — both fused into one node; its steady blocks
  run the fused kernel of ``ops/cuda/additive.py`` for all voices at once.

All three take a leading instance axis in ``process_block`` (``BATCHED``):
state ``[C, ...]``, inputs ``[C, B, ...]``, gate buffers ``[C, K]``.
Indices that the JAX package left to its clamping gathers are clamped
explicitly (a CUDA gather out of range is a device-side fault).
Transcendentals and divisions by constants go through ``ops/fmath.py`` so
the CPU and the card compute the same float32 values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import SampleRate, event, stream, value
from ..graph.node import Node, select_tree
from ..ops import fmath

NUM_HARMONICS = 32
INTERPOLATION_STEPS = 64
CYCLE = INTERPOLATION_STEPS + 1  # 64 interp ticks + 1 settle tick

# Reference amplitude spectra sampled from electric piano sounds
# (electric_piano_voice.rs:10-47)
VELOCITY_0_SPECTRUM = np.array(
    [0.02, 0.05] + [0.0] * 30, np.float32)

VELOCITY_127_SPECTRUM = np.array([
    0.150869, 0.385766, 0.215543, 0.117811, 0.100411, 0.0128637,
    0.0288844, 0.00243388, 0.00963092, 0.0035634, 0.00256945, 0.00184799,
    0.000399878, 0.000660576, 3.00995e-05, 0.00021866, 9.33705e-05,
    0.000177973, 0.0002545, 0.000323602, 0.000779045, 0.000116569,
    0.000772873, 0.000364486, 0.000248027, 0.00018236, 3.27292e-05,
    6.64988e-05, 0.0, 0.0, 0.0, 0.0], np.float32)

HARMONIC_NUMBERS = np.arange(1, NUM_HARMONICS + 1, dtype=np.float32)

# current_k = target + (C0-target)·P_k with P_k = Π_{i=1..k} (1 - i/64),
# over the 65-tick cycle (P_0 = 1 … P_64 = 0; index 64 doubles as the
# settle tick's factor 0).
_P_TABLE = np.ones((CYCLE,), np.float32)
_P_TABLE[1:] = np.cumprod(
    (INTERPOLATION_STEPS - np.arange(1, CYCLE, dtype=np.float32))
    / INTERPOLATION_STEPS)


# the module's numpy constants on each device they were asked for there
_DEVICE_CONSTS: dict = {}


def _f32(x, like):
    """The module constant ``x`` (a numpy array) as float32 on ``like``'s
    device, copied there once: a host-to-device copy inside a steady block
    would wait for the card."""
    key = (id(x), like.device)
    hit = _DEVICE_CONSTS.get(key)
    if hit is None or hit[0] is not x:
        hit = (x, torch.as_tensor(x, dtype=torch.float32, device=like.device))
        _DEVICE_CONSTS[key] = hit
    return hit[1]


def _powers(z_re, z_im, n: int):
    """z^1..z^n stacked on a new leading axis, by doubling: the table of
    z^1..z^h times z^h gives z^(h+1)..z^2h.  log2(n) batched complex
    multiplies.  The product order differs from the JAX package's
    associative scan, so entries differ at ulp level."""
    pr, pi = z_re[None], z_im[None]
    while pr.shape[0] < n:
        hr, hi = pr[-1], pi[-1]          # z^h
        nr = pr * hr - pi * hi
        ni = pr * hi + pi * hr
        pr = torch.cat([pr, nr])[:n]
        pi = torch.cat([pi, ni])[:n]
    return pr, pi


def _complex_pow_tables(z_re, z_im, max_exp: int):
    """Power tables for z^e, e in [0, max_exp], split into low (e & 15)
    and high (e >> 4) factors, so a rotation by e samples is two gathers
    and one complex multiply instead of sin/cos.  ``z`` is ``[C, H]``;
    the tables are ``[C, 16, H]`` and ``[C, n_hi + 1, H]``."""
    lo_r, lo_i = _powers(z_re, z_im, 15)               # z^1..z^15
    one = torch.ones_like(z_re)[None]
    zero = torch.zeros_like(z_im)[None]
    lo_r = torch.cat([one, lo_r])                      # z^0..z^15
    lo_i = torch.cat([zero, lo_i])
    z16_r = lo_r[-1] * z_re - lo_i[-1] * z_im
    z16_i = lo_r[-1] * z_im + lo_i[-1] * z_re
    n_hi = (max_exp >> 4) + 1
    hi_r, hi_i = _powers(z16_r, z16_i, n_hi)
    hi_r = torch.cat([one, hi_r])
    hi_i = torch.cat([zero, hi_i])
    return tuple(t.transpose(0, 1) for t in (lo_r, lo_i, hi_r, hi_i))


def _gather_rows(table, idx):
    """``table[c, idx[c, b], :]`` for a ``[C, N, H]`` table and ``[C, B]``
    indices, clamped into range."""
    idx = idx.clamp(0, table.shape[1] - 1).long()
    return torch.gather(
        table, 1, idx[:, :, None].expand(-1, -1, table.shape[2]))


def _pow_gather(tables, e):
    """z^e via the split tables; ``e`` int ``[C, B]`` -> ``[C, B, H]``."""
    lo_r, lo_i, hi_r, hi_i = tables
    el = e & 15
    eh = e >> 4
    lr, li = _gather_rows(lo_r, el), _gather_rows(lo_i, el)
    hr, hi_ = _gather_rows(hi_r, eh), _gather_rows(hi_i, eh)
    return lr * hr - li * hi_, lr * hi_ + li * hr


def _at_offset(v, off):
    """``v[c, off[c]]`` for ``[C, B, ...]`` values (offsets clamped)."""
    off = off.clamp(0, v.shape[1] - 1).long()
    idx = off.reshape((-1, 1) + (1,) * (v.dim() - 2)).expand(
        (v.shape[0], 1) + tuple(v.shape[2:]))
    return torch.gather(v, 1, idx)[:, 0]


class OscillatorBank(Node):
    """32-harmonic additive oscillator via complex rotation."""

    INPUTS = (value("frequency", 440.0), event("gate"),
              stream("amplitudes", 0.0, shape=(NUM_HARMONICS,)))
    OUTPUTS = (stream("output"),)
    BATCHED = True

    def init_state(self, sr: SampleRate):
        f32 = torch.float32
        return {
            "osc_re": torch.ones((NUM_HARMONICS,), dtype=f32),
            "osc_im": torch.zeros((NUM_HARMONICS,), dtype=f32),
            "mul_re": torch.ones((NUM_HARMONICS,), dtype=f32),
            "mul_im": torch.zeros((NUM_HARMONICS,), dtype=f32),
            "last_frequency": torch.tensor(0.0, dtype=f32),
        }

    def on_gate(self, state, velocity, sr, ins):
        """Note-on resets the oscillators to zero phase (:116-123)."""
        reset = {**state,
                 "osc_re": torch.ones_like(state["osc_re"]),
                 "osc_im": torch.zeros_like(state["osc_im"])}
        return select_tree(velocity > 0.0, reset, state)

    @staticmethod
    def _multipliers(freq, sr_hz):
        """Per-harmonic rotation multipliers for frequencies ``[C]``."""
        harm_freq = freq[:, None] * _f32(HARMONIC_NUMBERS, freq)
        angle = fmath.div(2.0 * math.pi * harm_freq, sr_hz)
        below = harm_freq < (sr_hz * 0.5)
        mul_re = torch.where(below, fmath.cos(angle), 1.0)
        mul_im = torch.where(below, fmath.sin(angle), 0.0)
        return mul_re, mul_im

    def process_block(self, state, ins, events, sr, block_len):
        """Closed-form rotation, segmented at gate events: osc(k) =
        osc0 * m^(k+1).  The frequency can only change at event boundaries
        (MidiVoiceHandler emits frequency steps with the gate events), so
        each segment reads it at its first sample and applies the
        reference's change-detection reset there."""
        B = block_len
        freq_in = ins["frequency"]                       # [C, B]
        dev = freq_in.device
        buf = events.get("gate")
        K = buf.capacity if buf is not None else 0
        t_idx = torch.arange(B, dtype=torch.float32, device=dev)[None, :]
        C = freq_in.shape[0]

        seg_start = torch.zeros((C,), dtype=torch.float32, device=dev)
        re0, im0 = state["osc_re"], state["osc_im"]
        mre, mim = state["mul_re"], state["mul_im"]
        last = state["last_frequency"]
        out_im = torch.zeros((C, B, NUM_HARMONICS), dtype=torch.float32,
                             device=dev)
        for j in range(K + 1):
            f = _at_offset(freq_in, seg_start)
            changed = torch.logical_and(f > 0.0,
                                        torch.abs(last - f) >= 0.01)
            n_mre, n_mim = self._multipliers(f, sr.hz)
            ch = changed[:, None]
            mre = torch.where(ch, n_mre, mre)
            mim = torch.where(ch, n_mim, mim)
            re0 = torch.where(ch, 1.0, re0)
            im0 = torch.where(ch, 0.0, im0)
            last = torch.where(changed, f, last)

            if j < K:
                valid = buf.valid[:, j]
                fired = torch.logical_and(valid, buf.values[:, j] > 0.0)
                end = torch.where(
                    valid, buf.offsets[:, j].clamp(0, B).to(torch.float32),
                    float(B))
            else:
                end = torch.full_like(seg_start, float(B))

            tables = _complex_pow_tables(mre, mim, B)
            k = t_idx - seg_start[:, None]                # [C, B]
            e = torch.clamp(k + 1.0, 0.0, float(B)).to(torch.int32)
            wr, wi = _pow_gather(tables, e)               # [C, B, H]
            seg_im = re0[:, None, :] * wi + im0[:, None, :] * wr
            mask = torch.logical_and(t_idx >= seg_start[:, None],
                                     t_idx < end[:, None])[:, :, None]
            out_im = torch.where(mask, seg_im, out_im)
            # state at segment end
            n_seg = torch.clamp(end - seg_start, min=0.0)
            er, ei = _pow_gather(tables, n_seg.to(torch.int32)[:, None])
            er, ei = er[:, 0], ei[:, 0]
            moved = (n_seg > 0)[:, None]
            end_re = torch.where(moved, re0 * er - im0 * ei, re0)
            end_im = torch.where(moved, re0 * ei + im0 * er, im0)
            if j < K:
                # gate-on at `end` resets phase before that sample runs
                fr = fired[:, None]
                re0 = torch.where(fr, 1.0, end_re)
                im0 = torch.where(fr, 0.0, end_im)
                seg_start = end
            else:
                re0, im0 = end_re, end_im

        out = torch.sum(out_im * ins["amplitudes"], dim=-1) * 3.0
        return ({"osc_re": re0, "osc_im": im0, "mul_re": mre,
                 "mul_im": mim, "last_frequency": last},
                {"output": out})


def _get_decay(note, decay_rate, harmonic_decay, key_scaling):
    """Per-harmonic hold-phase decay multipliers (:232-255); ``[C]`` ->
    ``[C, H]``."""
    base = fmath.div(100.0 - decay_rate, 40000.0)
    harmonic_scaling = 1.0 - fmath.div(100.0 - harmonic_decay, 200000.0)
    scaling_multiplier = (48.0 - note) / 12.0
    ks = scaling_multiplier * (key_scaling * 0.02)
    adjusted = torch.where(ks > 0.0,
                           1.0 - (base / (1.0 + ks)),
                           1.0 - (base * (1.0 - ks)))
    idx = torch.arange(NUM_HARMONICS, dtype=torch.float32,
                       device=decay_rate.device)
    scaling = fmath.pow(harmonic_scaling[:, None], idx)
    return adjusted[:, None] * scaling


def _get_release(release_rate):
    """(:257-261); ``[C]`` -> ``[C, H]``."""
    rel = 0.999 - fmath.div(100.0 - release_rate, 1000.0)
    return torch.ones((rel.shape[0], NUM_HARMONICS), dtype=torch.float32,
                      device=rel.device) * rel[:, None]


def _initial_amplitudes(velocity, brightness, velocity_scaling):
    """(:263-280); ``[C]`` -> ``[C, H]``."""
    v = velocity[:, None]
    amps = (_f32(VELOCITY_127_SPECTRUM, v) * v
            + _f32(VELOCITY_0_SPECTRUM, v) * (1.0 - v))
    b = -0.2 + (0.8 * (brightness * 0.01))
    b = b + velocity * velocity_scaling * 0.01 * 0.5
    idx = torch.arange(NUM_HARMONICS, dtype=torch.float32, device=v.device)
    return amps * (1.0 + b[:, None] * idx)


class AmplitudeSource(Node):
    """Per-harmonic envelope source with 64-sample interpolation cycles."""

    INPUTS = (value("frequency", 440.0), event("gate"),
              value("brightness", 30.0), value("velocity_scaling", 50.0),
              value("decay_rate", 90.0), value("harmonic_decay", 70.0),
              value("key_scaling", 50.0), value("release_rate", 40.0))
    OUTPUTS = (stream("amplitudes", shape=(NUM_HARMONICS,)),)
    BATCHED = True

    NOTE_PITCH = 60.0  # reference keeps note_pitch at its ctor value

    def init_state(self, sr: SampleRate):
        z = torch.zeros((NUM_HARMONICS,), dtype=torch.float32)
        return {"current": z, "target": z.clone(),
                "decay": z.clone(), "release": z.clone(),
                "released": torch.tensor(False),
                "velocity": torch.tensor(0.0, dtype=torch.float32),
                "step": torch.tensor(INTERPOLATION_STEPS,
                                     dtype=torch.int32)}

    def on_gate(self, state, velocity, sr, ins):
        """trigger_note / release_note (:282-305) for ``[C]`` velocities
        and per-instance inputs ``[C]``."""
        zero_step = torch.zeros_like(state["step"])
        trig = {**state,
                "velocity": velocity,
                "decay": _get_decay(self.NOTE_PITCH, ins["decay_rate"],
                                    ins["harmonic_decay"],
                                    ins["key_scaling"]),
                "release": _get_release(ins["release_rate"]),
                "current": _initial_amplitudes(velocity, ins["brightness"],
                                               ins["velocity_scaling"]),
                "released": torch.zeros_like(state["released"]),
                "step": zero_step}
        rel = {**state, "released": torch.ones_like(state["released"]),
               "step": zero_step}
        return select_tree(velocity > 0.0, trig, rel)

    def process_block(self, state, ins, events, sr, block_len):
        """Closed form over the 65-tick cycle: within cycle n at interp
        step j, current = C0 * m^n * (1 - (j/64)(1-m)); the settle tick
        (j == 0 after wrap) holds the cycle-end value."""
        B = block_len
        any_in = ins["frequency"]
        dev = any_in.device
        C = any_in.shape[0]
        t_idx = torch.arange(B, dtype=torch.float32, device=dev)[None, :]
        buf = events.get("gate")
        K = buf.capacity if buf is not None else 0
        P = _f32(_P_TABLE, any_in)
        n_max = (INTERPOLATION_STEPS + B) // CYCLE + 2

        def mult_of(st):
            return torch.where(st["released"][:, None], st["release"],
                               st["decay"])

        def cycle_factor(m, jj):
            """m + (1-m)·P_j — the within-cycle blend factor; ``jj``
            ``[C]`` or ``[C, B]``."""
            pj = P[jj.clamp(0, CYCLE - 1).long()]
            if jj.dim() == 2:
                return m[:, None, :] + (1.0 - m[:, None, :]) * pj[..., None]
            return m + (1.0 - m) * pj[:, None]

        def c_base_of(st, m):
            """Reconstruct the cycle-base value from a mid-cycle state."""
            frac0 = cycle_factor(m, st["step"])
            return st["current"] / torch.clamp(frac0, min=1e-30)

        def m_pow_table(m):
            """m^0..m^n_max as ``[C, n_max + 1, H]`` (doubling, as in
            _powers; the JAX package uses an associative scan)."""
            pw = m[None]
            while pw.shape[0] < n_max:
                pw = torch.cat([pw, pw * pw[-1]])[:n_max]
            return torch.cat([torch.ones_like(m)[None], pw]).transpose(0, 1)

        def seg_eval(st, k):
            """amplitudes after k+1 ticks from st; k ``[C, B]`` >= 0."""
            m = mult_of(st)
            c_base = c_base_of(st, m)
            a = st["step"].to(torch.float32)[:, None] + k + 1.0
            n = torch.floor(fmath.div(a, CYCLE))
            jj = a - n * CYCLE
            mn = _gather_rows(m_pow_table(m), n.to(torch.int32))
            return c_base[:, None, :] * mn * cycle_factor(m, jj)

        def seg_end_state(st, n_ticks):
            """state after n_ticks ``[C]`` ticks."""
            cur = seg_eval(st, (n_ticks - 1.0)[:, None])[:, 0]
            s0 = st["step"].to(torch.float32)
            a = s0 + n_ticks
            nn = torch.floor(fmath.div(a, CYCLE))
            new_step = a - nn * CYCLE
            m = mult_of(st)
            tgt = c_base_of(st, m) * fmath.exp(
                (nn + 1.0)[:, None] * fmath.log(torch.clamp(m, min=1e-30)))
            new = {**st, "current": cur, "target": tgt,
                   "step": new_step.to(torch.int32)}
            return select_tree(n_ticks > 0, new, st)

        amps = torch.zeros((C, B, NUM_HARMONICS), dtype=torch.float32,
                           device=dev)
        st = state
        start = torch.zeros((C,), dtype=torch.float32, device=dev)
        for j in range(K + 1):
            if j < K:
                end = torch.where(buf.valid[:, j],
                                  buf.offsets[:, j].clamp(0, B),
                                  B).to(torch.float32)
            else:
                end = torch.full_like(start, float(B))
            lv = seg_eval(st, torch.clamp(t_idx - start[:, None], min=0.0))
            mask = torch.logical_and(t_idx >= start[:, None],
                                     t_idx < end[:, None])[:, :, None]
            amps = torch.where(mask, lv, amps)
            st = seg_end_state(st, end - start)
            if j < K:
                off = buf.offsets[:, j]
                p_ev = {k: _at_offset(v, off) for k, v in ins.items()}
                fired = torch.logical_and(buf.valid[:, j], off < B)
                st = select_tree(
                    fired, self.on_gate(st, buf.values[:, j], sr, p_ev), st)
                start = end
        return st, {"amplitudes": amps}


class ElectricPianoVoice(Node):
    """Fused additive voice: AmplitudeSource → OscillatorBank composed in
    one node (the reference's ElectricPianoVoiceNode subgraph,
    electric_piano_voice.rs:362-403, as a single processor).

    Event-free blocks of a voice array run ONE fused kernel for all voices
    (``process_block_batched``); event blocks compose the two nodes'
    closed forms.
    """

    OUTPUTS = (stream("output"),)
    BATCHED = True

    def __init__(self):
        self._amp = AmplitudeSource()
        self._bank = OscillatorBank()
        self.INPUTS = self._amp.INPUTS  # frequency, gate, 6 params

    def init_state(self, sr: SampleRate):
        return {"amp": self._amp.init_state(sr),
                "bank": self._bank.init_state(sr)}

    def on_gate(self, state, velocity, sr, ins):
        return {"amp": self._amp.on_gate(state["amp"], velocity, sr, ins),
                "bank": self._bank.on_gate(state["bank"], velocity, sr,
                                           ins)}

    def process_block(self, state, ins, events, sr, block_len):
        amp_st, amp_out = self._amp.process_block(
            state["amp"], ins, events, sr, block_len)
        bank_ins = {"frequency": ins["frequency"],
                    "amplitudes": amp_out["amplitudes"]}
        bank_st, out = self._bank.process_block(
            state["bank"], bank_ins, events, sr, block_len)
        return ({"amp": amp_st, "bank": bank_st},
                {"output": out["output"]})

    def process_block_batched(self, state, ins, events, sr, block_len,
                              fanin_eps=frozenset(), epilogue=None):
        """All voices through one fused kernel (no events).  Returns None
        when the block length is not a multiple of the kernel's 8-sample
        granularity; such blocks take the composed path.

        When the compiler marks ``output`` as fan-in-only (its sole
        consumers sum over all voices), the mix-down runs inside the
        kernel and only the summed audio comes back, as
        ``__fanin__output``.  ``epilogue`` (``(ep, C, fn, params)``, the
        block compiler's stream-epilogue fusion) also runs the mix's single
        consumer inside the kernel; its ``[B, C]`` output comes back as
        ``__epi__output``."""
        from ..ops.cuda.additive import (_UNROLL, additive_voice_block,
                                         epilogue_supported, kernel_version)
        if block_len % _UNROLL:
            return None
        with_mix = "output" in fanin_eps
        if epilogue is not None and not (
                with_mix and epilogue[0] == "output"
                and epilogue_supported(ins["frequency"].shape[0])):
            epilogue = None
        from ..graph import explain
        if explain.active():
            explain.note(kernel=f"additive_voice_{kernel_version()}",
                         fanin_mixdown_fused=with_mix,
                         stream_epilogue_fused=epilogue is not None)

        bank = state["bank"]
        amp = state["amp"]
        freq = ins["frequency"][:, 0]  # [C] (block-constant, no events)
        changed = torch.logical_and(
            freq > 0.0, torch.abs(bank["last_frequency"] - freq) >= 0.01)
        ch = changed[:, None]
        n_mre, n_mim = OscillatorBank._multipliers(freq, sr.hz)
        mre = torch.where(ch, n_mre, bank["mul_re"])
        mim = torch.where(ch, n_mim, bank["mul_im"])
        ore = torch.where(ch, 1.0, bank["osc_re"])
        oim = torch.where(ch, 0.0, bank["osc_im"])
        last = torch.where(changed, freq, bank["last_frequency"])
        mult = torch.where(amp["released"][:, None], amp["release"],
                           amp["decay"])

        def plane(x):
            return x.t().contiguous()   # [C, H] -> [H, C]

        epi_kw = {}
        if epilogue is not None:
            _, epi_c, epi_fn, epi_params = epilogue
            epi_kw = dict(epi_fn=epi_fn, epi_c=epi_c, epi_params=epi_params)
        y, or_o, oi_o, cur_o, tgt_o, step_o = additive_voice_block(
            plane(ore), plane(oim), plane(mre), plane(mim),
            plane(amp["current"]), plane(amp["target"]), plane(mult),
            amp["step"], block_len, with_mix=with_mix, **epi_kw)
        new_state = {
            "bank": {**bank, "osc_re": or_o.t(), "osc_im": oi_o.t(),
                     "mul_re": mre, "mul_im": mim,
                     "last_frequency": last},
            "amp": {**amp, "current": cur_o.t(), "target": tgt_o.t(),
                    "step": step_o.to(torch.int32)},
        }
        if epilogue is not None:
            # y [B, C]: the consumer's output, computed after the mix
            return new_state, {"__epi__output": y}
        if with_mix:
            return new_state, {"__fanin__output": y}   # [B], pre-summed
        return new_state, {"output": y.t()}
