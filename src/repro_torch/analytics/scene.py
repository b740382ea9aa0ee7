"""Port of ``repro/analytics/scene.py``, verbatim: scenes keep the reference's
numpy RNG so their bytes equal the reference's.

Procedural traffic-camera scenes with ground truth.

Six streams mirror the paper's datasets: three surveillance cameras with
heavy/medium/light traffic (*jackson*, *miami*, *tucson*), a *dashcam* with
global camera motion, and two parking-lot cameras (*park*, *airport*).
Each segment is deterministic in (stream, segment_index): cars (textured
rectangles carrying digit license plates) translate across a static or
panning background, plus sensor noise.  Ground truth (car boxes, plate boxes,
digit strings per frame) is returned alongside the pixels for sanity tests —
operator *accuracy* is measured the paper's way, against the operator's own
output on full-fidelity video.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np

from ..core.knobs import IngestSpec


def _stream_seed(stream: str) -> int:
    """Stable per-stream seed.  Python's ``hash()`` is randomized per
    process (PYTHONHASHSEED), which silently made every process render
    different scenes — benchmarks comparing runs across processes (and the
    CI regression gate) need identical workloads, so use crc32."""
    return zlib.crc32(stream.encode())

# 7x5 digit glyph bitmaps.
_DIGITS_ROWS = {
    0: ("11111", "10001", "10001", "10001", "10001", "10001", "11111"),
    1: ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    2: ("11111", "00001", "00001", "11111", "10000", "10000", "11111"),
    3: ("11111", "00001", "00001", "01111", "00001", "00001", "11111"),
    4: ("10001", "10001", "10001", "11111", "00001", "00001", "00001"),
    5: ("11111", "10000", "10000", "11111", "00001", "00001", "11111"),
    6: ("11111", "10000", "10000", "11111", "10001", "10001", "11111"),
    7: ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    8: ("11111", "10001", "10001", "11111", "10001", "10001", "11111"),
    9: ("11111", "10001", "10001", "11111", "00001", "00001", "11111"),
}


@functools.cache
def digit_glyphs() -> np.ndarray:
    """(10, 7, 5) float32 in {0,1}."""
    out = np.zeros((10, 7, 5), np.float32)
    for d, rows in _DIGITS_ROWS.items():
        for i, row in enumerate(rows):
            for j, ch in enumerate(row):
                out[d, i, j] = float(ch == "1")
    return out


STREAMS = {
    #  name     : (cars/segment rate, car speed px/frame, global pan, plate prob)
    "jackson":   (3.0, 3.0, 0.0, 0.9),
    "miami":     (2.2, 2.5, 0.0, 0.9),
    "tucson":    (1.5, 2.0, 0.0, 0.9),
    "dashcam":   (2.0, 4.0, 1.5, 0.8),
    "park":      (1.0, 1.2, 0.0, 0.9),
    "airport":   (0.8, 1.0, 0.0, 0.9),
    "empty":     (0.0, 1.0, 0.0, 0.9),   # calibration / negative control
}


@dataclasses.dataclass
class CarTruth:
    car_id: int
    digits: str
    boxes: dict[int, tuple[int, int, int, int]]        # frame -> (y0,x0,y1,x1)
    plate_boxes: dict[int, tuple[int, int, int, int]]  # frame -> (y0,x0,y1,x1)


@dataclasses.dataclass
class SegmentTruth:
    stream: str
    seg: int
    cars: list[CarTruth]


def _background(stream: str, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(_stream_seed(stream))
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None, :]
    bg = 90 + 50 * y + 15 * np.sin(x * 13) + 10 * np.cos(y * 21 + x * 7)
    bg += rng.normal(0, 6, (h, w))  # fixed texture
    # road band
    road0, road1 = int(h * 0.45), int(h * 0.95)
    bg[road0:road1] = 70 + 8 * np.sin(x * 31)
    return bg.clip(0, 255)


def _draw_car(frame: np.ndarray, y0: int, x0: int, ch: int, cw: int,
              shade: float, digits: str, with_plate: bool):
    h, w = frame.shape
    y1, x1 = y0 + ch, x0 + cw
    vy0, vx0 = max(0, y0), max(0, x0)
    vy1, vx1 = min(h, y1), min(w, x1)
    if vy1 <= vy0 or vx1 <= vx0:
        return None, None
    # body with simple shading + window band
    yy = np.arange(vy0, vy1)[:, None]
    frame[vy0:vy1, vx0:vx1] = shade + 12 * np.sin((yy - y0) / 4)
    wy0, wy1 = y0 + ch // 6, y0 + ch // 3
    frame[max(0, wy0):min(h, wy1), vx0:vx1] = shade * 0.4
    plate_box = None
    if with_plate:
        glyphs = digit_glyphs()
        ph, pw = 9, 2 + 4 * 6  # 7x5 glyphs + 1px spacing + 1px border
        py0 = y0 + (2 * ch) // 3
        px0 = x0 + (cw - pw) // 2
        py1, px1 = py0 + ph, px0 + pw
        if py0 >= 0 and px0 >= 0 and py1 <= h and px1 <= w:
            frame[py0:py1, px0:px1] = 235.0  # white plate
            for i, d in enumerate(digits):
                g = glyphs[int(d)]
                gy, gx = py0 + 1, px0 + 1 + i * 6
                frame[gy:gy + 7, gx:gx + 5] -= 215.0 * g  # dark digits
            plate_box = (py0, px0, py1, px1)
    return (vy0, vx0, vy1, vx1), plate_box


def generate_segment(stream: str, seg: int,
                     spec: IngestSpec | None = None
                     ) -> tuple[np.ndarray, SegmentTruth]:
    """Render one segment at ingest fidelity.  Deterministic."""
    spec = spec or IngestSpec()
    n, h, w = spec.frames_per_segment, spec.height, spec.width
    rate, speed, pan, plate_p = STREAMS.get(stream, STREAMS["tucson"])
    rng = np.random.default_rng(_stream_seed(stream) * 1000003 + seg)

    bg = _background(stream, h, w + int(abs(pan) * n) + 8)
    n_cars = rng.poisson(rate)
    cars = []
    for c in range(n_cars):
        ch = int(rng.integers(max(18, h // 4), max(24, h // 2)))
        cw = int(ch * rng.uniform(1.3, 1.7))
        lane_y = int(rng.uniform(0.45, max(0.451, 0.95 - ch / h)) * h)
        v = speed * rng.uniform(0.7, 1.4) * rng.choice([-1.0, 1.0])
        x_start = (-cw - rng.uniform(0, w * 0.5)) if v > 0 else \
            (w + rng.uniform(0, w * 0.5))
        shade = rng.uniform(140, 220)
        digits = "".join(str(d) for d in rng.integers(0, 10, 4))
        has_plate = rng.random() < plate_p
        cars.append((c, ch, cw, lane_y, v, x_start, shade, digits, has_plate))

    frames = np.empty((n, h, w), np.float32)
    truths = [CarTruth(c[0], c[7], {}, {}) for c in cars]
    noise = rng.normal(0, 2.0, (n, h, w)).astype(np.float32)
    for t in range(n):
        off = int(round(pan * t))
        frame = bg[:, off:off + w].copy()
        for (cid, ch, cw, ly, v, xs, shade, digits, has_plate), tr in \
                zip(cars, truths):
            x = int(round(xs + v * t))
            box, pbox = _draw_car(frame, ly, x, ch, cw, shade, digits, has_plate)
            if box is not None:
                tr.boxes[t] = box
            if pbox is not None:
                tr.plate_boxes[t] = pbox
        frames[t] = frame
    frames = (frames + noise).clip(0, 255)
    return frames.astype(np.uint8), SegmentTruth(stream, seg, truths)
