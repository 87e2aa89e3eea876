"""ADSR envelope, exact per-sample op order: CUDA kernel and plain version.

Counterpart of ``oscen_tpu/ops/pallas/adsr.py``: one event-free block of
the reference's per-sample state machine (envelope/adsr.rs process():
update_sustain_level, then process_stage) for every voice, with the stage
lengths and one-pole coefficients block-constant ``[V]`` rows.  As in the
JAX package it is not wired into ``AdsrEnvelope`` (whose block path is the
closed forms); it is the building block of a fused voice kernel.

Selection: a CPU tensor runs :func:`plain_adsr_scan`, a CUDA tensor runs the
kernel of ``csrc/adsr.cu`` (built at first use) or raises.  ``launches``
counts the kernel's launches; the plain version is not counted.
"""

from __future__ import annotations

from typing import Dict

import torch

IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = 0.0, 1.0, 2.0, 3.0, 4.0
# the rows of state7
STATE_ROWS = ("stage", "rem", "level", "target", "sustain_level",
              "velocity", "release_inc")

KERNEL = "adsr_scan"
launches: Dict[str, int] = {KERNEL: 0}


def reset_launches() -> None:
    launches[KERNEL] = 0


def adsr_scan(state7, a_n, d_n, r_n, a_c, d_c, sus_param):
    """One event-free block of the ADSR for all voices.

    ``state7``: ``[7, V]`` float rows (``STATE_ROWS``); ``a_n``/``d_n``/
    ``r_n`` stage lengths and ``a_c``/``d_c`` one-pole coefficients, each
    ``[V]``; ``sus_param`` the clamped sustain parameter per sample
    ``[B, V]``.  Returns (levels ``[B, V]``, ``state7'``).
    """
    if sus_param.dim() != 2:
        raise ValueError(f"sus_param must be [B, V] (got "
                         f"{tuple(sus_param.shape)})")
    B, V = sus_param.shape
    if tuple(state7.shape) != (7, V):
        raise ValueError(f"state7 must be [7, {V}] (got "
                         f"{tuple(state7.shape)})")
    rows = (a_n, d_n, r_n, a_c, d_c)
    for nm, r in zip(("a_n", "d_n", "r_n", "a_c", "d_c"), rows):
        if tuple(r.shape) != (V,):
            raise ValueError(f"{nm} must be [{V}] (got {tuple(r.shape)})")
    if sus_param.device.type == "cpu":
        return plain_adsr_scan(state7, *rows, sus_param)
    if sus_param.device.type != "cuda":
        raise ValueError(f"no adsr_scan kernel for device "
                         f"{sus_param.device}")
    from . import build
    build.check_operands(sus_param.device, state7=state7, a_n=a_n, d_n=d_n,
                         r_n=r_n, a_c=a_c, d_c=d_c, sus_param=sus_param)
    levels = torch.empty_like(sus_param)
    st_o = torch.empty_like(state7)
    fn = build.entry("adsr", "oscen_adsr_scan", 9, 2)
    rc = fn(state7.data_ptr(), *[r.data_ptr() for r in rows],
            sus_param.data_ptr(), levels.data_ptr(), st_o.data_ptr(), V, B,
            torch.cuda.current_stream(sus_param.device).cuda_stream)
    launches[KERNEL] += 1
    build.check_launch("adsr", rc, KERNEL)
    return levels, st_o


def plain_adsr_scan(state7, a_n, d_n, r_n, a_c, d_c, sus_param):
    """The kernel's per-sample loop in plain PyTorch, over ``[V]`` rows;
    every select chain is the kernel's, in its order."""
    stage, rem, level, target, sus, vel, rinc = state7.unbind(0)
    where = torch.where
    levels = torch.empty_like(sus_param)
    for t in range(sus_param.shape[0]):
        # update_sustain_level (adsr.rs:92-115)
        sus = torch.clamp(sus_param[t] * vel, 0.0, 1.0)
        cap = where(stage == ATTACK, a_n,
                    where(stage == DECAY, d_n,
                          where(stage == RELEASE, r_n, rem)))
        clamped = torch.clamp_min(torch.minimum(rem, cap), 1.0)
        timed = (stage >= ATTACK) & (stage != SUSTAIN)
        rem = where(timed & (rem > 0.0), clamped, rem)
        target = where((stage == DECAY) | (stage == SUSTAIN), sus,
                       where(stage == RELEASE, 0.0, target))
        cur = torch.clamp(level, 0.0, 1.0)
        rinc = where(stage == RELEASE,
                     where((rem == 0.0) | (cur <= 0.0), 0.0,
                           -cur / torch.clamp_min(rem, 1.0)),
                     rinc)
        # process_stage (adsr.rs:206-248)
        act_a = (stage == ATTACK) & (rem > 0.0)
        act_d = (stage == DECAY) & (rem > 0.0)
        act_r = (stage == RELEASE) & (rem > 0.0)
        lvl_a = torch.clamp(level + (1.0 - level) * a_c, 0.0, 1.0)
        lvl_d = torch.clamp(level + (sus - level) * d_c, 0.0, 1.0)
        lvl_r = torch.clamp(level + rinc, 0.0, 1.0)
        level = where(act_a, lvl_a,
                      where(act_d, lvl_d,
                            where(act_r, lvl_r,
                                  where(stage == SUSTAIN, sus,
                                        where(stage == IDLE, 0.0, level)))))
        rem = where(act_a | act_d | act_r, rem - 1.0, rem)
        done_a = (stage == ATTACK) & (rem == 0.0)
        done_d = (stage == DECAY) & (rem == 0.0)
        done_r = (stage == RELEASE) & (rem == 0.0)
        level = where(done_a, 1.0,
                      where(done_d, sus, where(done_r, 0.0, level)))
        stage = where(done_a, DECAY,
                      where(done_d, SUSTAIN, where(done_r, IDLE, stage)))
        rem = where(done_a, d_n, rem)
        target = where(done_a, torch.clamp(sus, 0.0, 1.0), target)
        rinc = where(done_a | done_d | done_r, 0.0, rinc)
        levels[t] = level
    return levels, torch.stack([stage, rem, level, target, sus, vel, rinc])
