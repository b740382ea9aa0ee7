"""Port of ``repro/core/knobs.py``, verbatim: the knob spaces are pure Python.

Video-format knob spaces (paper Table 1).

Fidelity knobs (4): image quality, crop factor, resolution, frame sampling.
Coding knobs (3): speed step, keyframe interval, coding bypass.

A ``FidelityOption`` is a point in the 4D fidelity space F; a ``CodingOption``
is a point in the coding space C.  Storage formats live in F x C; consumption
formats live in F.  The *richer-than* relation is a partial order over F
(knob-wise >=, strict on at least one knob).

Knob values keep the paper's names (e.g. resolution "720p") but map onto a
configurable ``IngestSpec`` pixel grid so the whole system scales from
laptop-size tests to full-resolution runs without touching any algorithm.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

# ---------------------------------------------------------------------------
# Knob value ladders (paper Table 1). Order = poorest ... richest.
# ---------------------------------------------------------------------------

# Image quality -> quantization scale of the codec (CRF-like).  "best" is
# near-lossless.  Paper: CRF = 50, 40, 23, 0.
QUALITY_VALUES = ("worst", "bad", "good", "best")
QUALITY_QUANT_SCALE = {"worst": 16.0, "bad": 6.0, "good": 2.0, "best": 1.0}

# Crop factor: retain the central crop of this fraction (both axes).
CROP_VALUES = (0.50, 0.75, 1.00)

# Resolution ladder: 10 rungs, paper 60x60 ... 720p.  Stored as the paper's
# nominal vertical resolution; resolved against IngestSpec proportionally.
RESOLUTION_VALUES = (60, 100, 144, 180, 200, 270, 360, 400, 540, 720)

# Frame sampling: fraction of frames consumed.
SAMPLING_VALUES = (1 / 30, 1 / 5, 1 / 2, 2 / 3, 1.0)

# Coding speed step: slowest ... fastest (paper: x264 presets veryslow ...
# ultrafast).  Mapped to zstd level + transform effort in the codec.
SPEED_VALUES = ("slowest", "slow", "med", "fast", "fastest")
SPEED_ZSTD_LEVEL = {"slowest": 19, "slow": 12, "med": 7, "fast": 3, "fastest": 1}

# Keyframe interval (frames per independently-decodable chunk).
KEYFRAME_VALUES = (5, 10, 50, 100, 250)

# Coding bypass: True => store RAW frames (no coding knobs apply).
BYPASS_VALUES = (False, True)

FIDELITY_KNOBS = ("quality", "crop", "resolution", "sampling")
CODING_KNOBS = ("speed", "keyframe", "bypass")

# Index ladders for ordering comparisons.
_LADDER = {
    "quality": QUALITY_VALUES,
    "crop": CROP_VALUES,
    "resolution": RESOLUTION_VALUES,
    "sampling": SAMPLING_VALUES,
}


@dataclasses.dataclass(frozen=True, order=True)
class FidelityOption:
    """A point f in the 4D fidelity space."""

    quality: str = "best"
    crop: float = 1.0
    resolution: int = 720
    sampling: float = 1.0

    def __post_init__(self):
        if self.quality not in QUALITY_VALUES:
            raise ValueError(f"bad quality {self.quality!r}")
        if self.crop not in CROP_VALUES:
            raise ValueError(f"bad crop {self.crop!r}")
        if self.resolution not in RESOLUTION_VALUES:
            raise ValueError(f"bad resolution {self.resolution!r}")
        if self.sampling not in SAMPLING_VALUES:
            raise ValueError(f"bad sampling {self.sampling!r}")

    # -- ordering ----------------------------------------------------------
    def rank(self) -> tuple[int, int, int, int]:
        """Per-knob ladder indices (higher = richer)."""
        return (
            QUALITY_VALUES.index(self.quality),
            CROP_VALUES.index(self.crop),
            RESOLUTION_VALUES.index(self.resolution),
            SAMPLING_VALUES.index(self.sampling),
        )

    def richer_eq(self, other: "FidelityOption") -> bool:
        """True iff self is knob-wise >= other (the richer-than-or-equal
        partial order)."""
        a, b = self.rank(), other.rank()
        return all(x >= y for x, y in zip(a, b))

    def richer(self, other: "FidelityOption") -> bool:
        return self.richer_eq(other) and self != other

    def join(self, other: "FidelityOption") -> "FidelityOption":
        """Knob-wise maximum (least upper bound) — used by SF coalescing."""
        return FidelityOption(
            quality=_max_on(QUALITY_VALUES, self.quality, other.quality),
            crop=_max_on(CROP_VALUES, self.crop, other.crop),
            resolution=_max_on(RESOLUTION_VALUES, self.resolution, other.resolution),
            sampling=_max_on(SAMPLING_VALUES, self.sampling, other.sampling),
        )

    def with_knob(self, knob: str, value) -> "FidelityOption":
        return dataclasses.replace(self, **{knob: value})

    def name(self) -> str:
        q = self.quality
        return f"{q}-{self.resolution}p-{_frac(self.sampling)}-{int(self.crop * 100)}%"

    # quantization scale used by the codec for this quality value
    @property
    def quant_scale(self) -> float:
        return QUALITY_QUANT_SCALE[self.quality]


@dataclasses.dataclass(frozen=True, order=True)
class CodingOption:
    """A point c in the coding space.  ``bypass=True`` means RAW storage; the
    other knobs are then irrelevant and normalized to canonical values so RAW
    is a single point in the space."""

    speed: str = "med"
    keyframe: int = 50
    bypass: bool = False

    def __post_init__(self):
        if self.speed not in SPEED_VALUES:
            raise ValueError(f"bad speed {self.speed!r}")
        if self.keyframe not in KEYFRAME_VALUES:
            raise ValueError(f"bad keyframe {self.keyframe!r}")
        if self.bypass:
            # Normalize: RAW is one canonical point.
            object.__setattr__(self, "speed", "fastest")
            object.__setattr__(self, "keyframe", KEYFRAME_VALUES[0])

    @property
    def zstd_level(self) -> int:
        return SPEED_ZSTD_LEVEL[self.speed]

    def name(self) -> str:
        if self.bypass:
            return "RAW"
        return f"{self.keyframe}-{self.speed}"

    def cheaper_steps(self) -> list["CodingOption"]:
        """Successively cheaper-to-code options (used by budget adaptation):
        faster speed steps first, then RAW."""
        out = []
        i = SPEED_VALUES.index(self.speed)
        for s in SPEED_VALUES[i + 1:]:
            out.append(CodingOption(speed=s, keyframe=self.keyframe))
        out.append(CodingOption(bypass=True))
        return out


RAW = CodingOption(bypass=True)
GOLDEN_CODING = CodingOption(speed="slowest", keyframe=max(KEYFRAME_VALUES))


@dataclasses.dataclass(frozen=True, order=True)
class StorageFormat:
    """SF<f, c>: an on-disk video version."""

    fidelity: FidelityOption
    coding: CodingOption

    def name(self) -> str:
        return f"{self.fidelity.name()}|{self.coding.name()}"


# A consumption format CF<f> is just a FidelityOption; consumers subscribe to
# one.  We alias for readability.
ConsumptionFormat = FidelityOption


# ---------------------------------------------------------------------------
# Spaces
# ---------------------------------------------------------------------------

def fidelity_space() -> list[FidelityOption]:
    """The full 4D fidelity space F (600 options in the paper's ladders)."""
    return [
        FidelityOption(q, c, r, s)
        for q, c, r, s in itertools.product(
            QUALITY_VALUES, CROP_VALUES, RESOLUTION_VALUES, SAMPLING_VALUES
        )
    ]


def coding_space() -> list[CodingOption]:
    """Coding space C: 25 encoded options + RAW."""
    opts = [
        CodingOption(s, k)
        for s, k in itertools.product(SPEED_VALUES, KEYFRAME_VALUES)
    ]
    opts.append(RAW)
    return opts


def storage_space_size() -> int:
    return len(fidelity_space()) * len(coding_space())


def _max_on(ladder: tuple, a, b):
    return ladder[max(ladder.index(a), ladder.index(b))]


def _frac(x: float) -> str:
    for num, den in ((1, 30), (1, 5), (1, 2), (2, 3), (1, 1)):
        if abs(x - num / den) < 1e-9:
            return "1" if den == 1 else f"{num}/{den}"
    return f"{x:.3f}"


# ---------------------------------------------------------------------------
# Ingest spec: resolves paper-ladder knob values onto a concrete pixel grid.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IngestSpec:
    """The format in which camera streams arrive (paper: 720p30 h264).

    ``height``/``width``/``fps`` define the concrete grid of the *richest*
    fidelity; the paper-named resolution ladder maps proportionally onto it.
    Dimensions snap to multiples of 8 (DCT block size).
    """

    height: int = 96
    width: int = 160
    fps: int = 8
    segment_seconds: int = 4
    nominal: int = 720  # paper-name of the richest rung

    @property
    def frames_per_segment(self) -> int:
        return self.fps * self.segment_seconds

    def resolve(self, f: FidelityOption) -> tuple[int, int, int]:
        """(frames, height, width) of a segment in fidelity ``f``."""
        scale = f.resolution / self.nominal
        h = _snap8(self.height * scale * f.crop)
        w = _snap8(self.width * scale * f.crop)
        n = max(1, round(self.frames_per_segment * f.sampling))
        return n, h, w

    def frame_stride(self, f: FidelityOption) -> int:
        """Temporal stride implied by the sampling knob."""
        n = max(1, round(self.frames_per_segment * f.sampling))
        return max(1, self.frames_per_segment // n)

    def raw_bytes_per_segment(self, f: FidelityOption) -> int:
        n, h, w = self.resolve(f)
        return n * h * w  # uint8 grayscale


def _snap8(x: float) -> int:
    return max(8, int(round(x / 8)) * 8)


# Default reduced-scale spec used by tests & benches (laptop-affordable);
# examples may pass larger specs.
DEFAULT_INGEST = IngestSpec()


def unique_formats(formats: Iterable) -> list:
    """Stable de-dup preserving first-seen order."""
    seen, out = set(), []
    for f in formats:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out
