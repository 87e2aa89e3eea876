"""Core endpoint/event/sample-rate types.

Copy of ``oscen_tpu/core/types.py`` (framework-free) for the PyTorch port.
Values, streams, events and assets keep the reference's semantics (kind
checking, defaults, per-sample propagation) and are represented as torch
tensors with a trailing channel axis:

- a mono stream sample is a scalar array, a block is ``[B]``;
- a ``Frame<N>`` (reference frame.rs:12) is a trailing channel axis ``[N]`` /
  ``[B, N]``;
- node arrays (``[Ctor; N]``) add a leading instance axis.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

# Mirrors reference graph/types.rs:8-18 constants.
DEFAULT_MAX_BLOCK_SIZE = 512
MAX_EVENTS = 256
MAX_NODE_ENDPOINTS = 32
MAX_STREAM_CHANNELS = 128
MAX_STATIC_EVENTS_PER_ENDPOINT = 32

DEFAULT_SAMPLE_RATE = 44100.0


class Kind(enum.Enum):
    """Endpoint kind (reference graph/types.rs:24-31)."""

    STREAM = "stream"
    VALUE = "value"
    EVENT = "event"
    ASSET = "asset"


class Policy(enum.Enum):
    """Cross-rate edge resampling policy (reference dispatch/mod.rs:36-45)."""

    DEFAULT = "default"
    SINC = "sinc"        # 23-tap Kaiser halfband FIR cascade
    SINC_IIR = "sinc_iir"  # 2-branch allpass polyphase halfband
    LINEAR = "linear"
    LATCH = "latch"


@dataclass(frozen=True)
class Endpoint:
    """Declaration of one node endpoint.

    ``channels`` is the trailing channel count (1 == mono scalar, matching
    the reference's canonical ``f32``; >1 == ``Frame<N>``).  ``shape`` allows
    array-valued stream endpoints such as OscillatorBank.amplitudes
    (``[f32; 32]``, reference electric_piano_voice.rs:88).
    """

    name: str
    kind: Kind = Kind.STREAM
    default: Any = 0.0
    channels: int = 1
    shape: tuple = ()  # extra per-sample shape beyond channels (rare)

    @property
    def is_scalar(self) -> bool:
        return self.channels == 1 and self.shape == ()


def stream(name: str, default: float = 0.0, channels: int = 1,
           shape: tuple = ()) -> Endpoint:
    return Endpoint(name, Kind.STREAM, default, channels, shape)


def value(name: str, default: float = 0.0, channels: int = 1) -> Endpoint:
    return Endpoint(name, Kind.VALUE, default, channels)


def event(name: str) -> Endpoint:
    return Endpoint(name, Kind.EVENT, None)


def asset(name: str) -> Endpoint:
    return Endpoint(name, Kind.ASSET, None)


@dataclass(frozen=True)
class SampleRate:
    """Sample rate newtype (reference graph/types.rs:255-291).

    A static Python float, fixed before the processing loop is entered, as
    in the reference where ``set_sample_rate`` runs first.
    """

    hz: float = DEFAULT_SAMPLE_RATE

    @property
    def period(self) -> float:
        return 1.0 / self.hz

    @property
    def nyquist(self) -> float:
        return self.hz * 0.5

    def __float__(self) -> float:
        return float(self.hz)


@dataclass
class ParamSpec:
    """Parameter UI/host spec attached to a graph value input.

    Mirrors the reference's ``ParamSpec`` (ast.rs:173-199): range, log curve,
    ramp length in frames, and the nih-plug param fields, exported through
    :meth:`Graph.param_specs`.
    """

    min: Optional[float] = None
    max: Optional[float] = None
    log: bool = False
    ramp_frames: int = 0
    center: Optional[float] = None
    unit: str = ""
    step: Optional[float] = None
    smoother_ms: Optional[float] = None
    display_name: Optional[str] = None
    group: Optional[str] = None
    extra: dict = field(default_factory=dict)
