"""Port of ``repro/analytics/operators.py``: the six analytics operators as
PyTorch programs over uint8 frame tensors.

Query A (car detection):      Diff -> S-NN -> NN
Query B (license recognition): Motion -> License -> OCR

Each operator takes frames on any device and computes there: convolutions
are ``F.conv2d`` (the reference left them to XLA outside Pallas), and the
three resizes the reference did with ``jax.image.resize`` (NN's scale
pyramid, OCR's plate patch) go through ``codec.transform.resize``, i.e. the
K2 kernel on the card.  Thresholding and the quantisation of hit positions
onto the item grids also run on the device; only per-frame scores of a few
cells, the quantised hits and the OCR readings come back to the host, where
the items are assembled exactly as the reference assembles them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..codec import transform as T
from ..core.knobs import FidelityOption, IngestSpec
from .scene import digit_glyphs

Item = tuple


def _bucket(pos: int, spec: IngestSpec) -> int:
    return int(pos) // max(1, spec.fps // 2)


def _positions(cf: FidelityOption, spec: IngestSpec) -> np.ndarray:
    """Original-timeline positions of the consumed frames."""
    return T.sample_indices(spec.frames_per_segment, cf.sampling)


def _to_norm(y, x, h, w, crop):
    """Map pixel coords in a cropped/resized frame to full-view [0,1]^2."""
    ny = (np.asarray(y) + 0.5) / h * crop + (1 - crop) / 2
    nx = (np.asarray(x) + 0.5) / w * crop + (1 - crop) / 2
    return ny, nx


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as the reference divides, on every device.  On the
    card PyTorch divides by a Python number as a multiply by its
    reciprocal, which rounds differently: 204 / 255 lands one ulp above
    0.8, License's brightness test, and 426.5 / 853 one below 0.5, a cell
    edge of NN's item grid.  A 0-dim tensor divisor gets the true
    division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _grid_hits(mask: torch.Tensor, dy: int, dx: int, h: int, w: int,
               crop: float, q: int) -> np.ndarray:
    """Unique (frame, qy, qx) rows of the hits in an (n, H, W) mask: each
    hit (t, y, x) mapped by ``_to_norm(y + dy, x + dx, h, w, crop)`` onto
    the q-grid, in float64 with the reference's operation order, on the
    mask's device."""
    t, y, x = mask.nonzero(as_tuple=True)
    if t.numel() == 0:
        return np.empty((0, 3), np.int64)
    off = (1 - crop) / 2
    ny = _true_div((y + dy).to(torch.float64) + 0.5, h) * crop + off
    nx = _true_div((x + dx).to(torch.float64) + 0.5, w) * crop + off
    rows = torch.stack([t, (ny * q).to(torch.int64), (nx * q).to(torch.int64)],
                       dim=1)
    return torch.unique(rows, dim=0).cpu().numpy()


def _conv(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """NHW x (o, kh, kw) -> (n, o, h', w') valid cross-correlation."""
    return F.conv2d(x[:, None], kernels[:, None].to(x.dtype))


def _unit_float(frames_u8) -> torch.Tensor:
    return _true_div(torch.as_tensor(frames_u8).to(torch.float32), 255.0)


@functools.cache
def _on(device: torch.device, name: str) -> torch.Tensor:
    """An operator's constant weights as a float32 tensor on ``device``."""
    return torch.from_numpy(_CONSTS[name]()).to(device)


# ---------------------------------------------------------------------------
# Operator base
# ---------------------------------------------------------------------------

class Operator:
    name: str = "op"

    def detect(self, frames_u8: torch.Tensor, cf: FidelityOption,
               spec: IngestSpec, positions: np.ndarray | None = None
               ) -> set[Item]:
        """``positions`` gives the original-timeline index of each
        supplied frame (defaults to the full consumed set implied by
        ``cf.sampling``); cascades pass activated subsets."""
        raise NotImplementedError

    def __repr__(self):
        return f"<op {self.name}>"


# ---------------------------------------------------------------------------
# Diff: frame-difference event detector (cheapest)
# ---------------------------------------------------------------------------

def _diff_scores(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x[1:] - x[:-1]), dim=(1, 2))


class Diff(Operator):
    name = "diff"
    threshold = 0.012  # mean-abs-diff rate per original-timeline frame

    def detect(self, frames_u8, cf, spec, positions=None):
        x = _unit_float(frames_u8)
        if x.shape[0] < 2:
            return set()
        pos = _positions(cf, spec) if positions is None else positions
        gaps = np.maximum(1, np.diff(pos))
        scores = _diff_scores(x).cpu().numpy() / gaps  # per-frame change rate
        return {("evt", _bucket(pos[i + 1], spec))
                for i in np.nonzero(scores > self.threshold)[0]}


# ---------------------------------------------------------------------------
# Motion: tiled foreground/texture detector (works single-frame)
# ---------------------------------------------------------------------------

def _motion_tiles(x: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    gy = torch.abs(x[:, 1:, :-1] - x[:, :-1, :-1])
    gx = torch.abs(x[:, :-1, 1:] - x[:, :-1, :-1])
    e = gy + gx
    n, h, w = e.shape
    hh, ww = (h // ty) * ty, (w // tx) * tx
    e = e[:, :hh, :ww].reshape(n, ty, hh // ty, tx, ww // tx)
    return e.mean(dim=(2, 4))


class Motion(Operator):
    name = "motion"
    threshold = 0.06  # tile energy in excess of the frame's median tile
    grid = (4, 6)

    def detect(self, frames_u8, cf, spec, positions=None):
        ty, tx = self.grid
        x = _unit_float(frames_u8)
        n, h, w = x.shape
        if h < ty or w < tx:
            return set()
        tiles = _motion_tiles(x, ty, tx).cpu().numpy()
        # excess over the frame's median tile: robust to the uniform noise /
        # smoothing floor (quality knob), sensitive to car-specific edges
        med = np.median(tiles.reshape(n, -1), axis=1)[:, None, None]
        tiles = tiles - med
        pos = _positions(cf, spec) if positions is None else positions
        items = set()
        for t, iy, ix in zip(*np.nonzero(tiles > self.threshold)):
            cy, cx = _to_norm((iy + 0.5) * h / ty - 0.5, (ix + 0.5) * w / tx - 0.5,
                              h, w, cf.crop)
            items.add(("mot", _bucket(pos[t], spec),
                       int(cy * ty), int(cx * tx)))
        return items


# ---------------------------------------------------------------------------
# S-NN: small fixed convnet (shallow AlexNet stand-in)
# ---------------------------------------------------------------------------

def _snn_kernels() -> np.ndarray:
    k = np.zeros((3, 5, 5), np.float32)
    k[0, 2, :] = 1.0; k[0, 0, :] = -0.5; k[0, 4, :] = -0.5       # horiz edge
    k[1, :, 2] = 1.0; k[1, :, 0] = -0.5; k[1, :, 4] = -0.5       # vert edge
    k[2] = -1 / 25.; k[2, 1:4, 1:4] = (25 - 9) / (25. * 9)       # center-surround
    return k


def _snn_scores(x: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    a = torch.relu(_conv(x, _on(x.device, "snn")))
    a = (a * a).sum(dim=1)  # energy over channels
    n, h, w = a.shape
    hh, ww = (h // gy) * gy, (w // gx) * gx
    a = a[:, :hh, :ww].reshape(n, gy, hh // gy, gx, ww // gx)
    return a.mean(dim=(2, 4))


class SNN(Operator):
    name = "snn"
    threshold = 0.050
    grid = (3, 5)

    def detect(self, frames_u8, cf, spec, positions=None):
        gy, gx = self.grid
        x = _unit_float(frames_u8)
        n, h, w = x.shape
        if h < gy + 5 or w < gx + 5:
            return set()
        cells = _snn_scores(x, gy, gx).cpu().numpy()
        pos = _positions(cf, spec) if positions is None else positions
        items = set()
        for t, iy, ix in zip(*np.nonzero(cells > self.threshold)):
            cy, cx = _to_norm((iy + 0.5) * h / gy - 0.5, (ix + 0.5) * w / gx - 0.5,
                              h, w, cf.crop)
            items.add(("car", _bucket(pos[t], spec), int(cy * gy), int(cx * gx)))
        return items


# ---------------------------------------------------------------------------
# NN: multi-scale template detector (the expensive deep model stand-in)
# ---------------------------------------------------------------------------

def _nn_templates() -> np.ndarray:
    """4 zero-mean 12x12 car-part templates."""
    t = np.zeros((4, 12, 12), np.float32)
    t[0, 2:10, 1:11] = 1.0                       # bright body
    t[1, 3:6, 1:11] = -1.0; t[1, 7:10, 1:11] = 1.0   # dark window over body
    t[2, :, 2:4] = 1.0; t[2, :, 8:10] = -1.0     # vertical edge pair
    t[3, 4:8, 2:10] = 1.0; t[3, 5:7, 3:9] = -1.2  # plate-ish ring
    t -= t.mean(axis=(1, 2), keepdims=True)
    t /= np.linalg.norm(t, axis=(1, 2), keepdims=True)
    return t


def _nn_scale_scores(x: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    xs = T.resize(x, h2, w2)
    a = _conv(xs - xs.mean(dim=(1, 2), keepdim=True), _on(x.device, "nn"))
    return a.amax(dim=1)  # (n, h', w') best-template score


class NN(Operator):
    name = "nn"
    threshold = 1.7
    scales = (1.0, 2 / 3, 1 / 2)
    qgrid = 8

    def detect(self, frames_u8, cf, spec, positions=None):
        x = _unit_float(frames_u8)
        n, h, w = x.shape
        pos = _positions(cf, spec) if positions is None else positions
        items = set()
        for si, s in enumerate(self.scales):
            h2, w2 = max(14, int(h * s)), max(14, int(w * s))
            hits = _grid_hits(_nn_scale_scores(x, h2, w2) > self.threshold,
                              6, 6, h2, w2, cf.crop, self.qgrid)
            for t, qy, qx in hits:
                items.add(("carbox", _bucket(pos[t], spec), int(qy), int(qx),
                           si))
        return items


# ---------------------------------------------------------------------------
# License: plate-region detector (bright box + dense dark edges)
# ---------------------------------------------------------------------------

def _license_scores(x: torch.Tensor) -> torch.Tensor:
    bright = (x > 0.80).to(x.dtype)
    gx = torch.abs(torch.diff(x, dim=2))
    edge = (gx > 0.25).to(x.dtype)
    box = torch.ones((1, 5, 11), dtype=x.dtype, device=x.device) / (5 * 11)
    b = _conv(bright, box)[:, 0]
    e = _conv(edge, box)[:, 0, :, :-1]
    hh = min(b.shape[1], e.shape[1]); ww = min(b.shape[2], e.shape[2])
    return b[:, :hh, :ww] * e[:, :hh, :ww]


class License(Operator):
    name = "license"
    threshold = 0.035
    qgrid = 12

    def score_map(self, frames_u8) -> torch.Tensor:
        x = _unit_float(frames_u8)
        if x.shape[1] < 7 or x.shape[2] < 13:
            return torch.zeros((x.shape[0], 1, 1), dtype=torch.float32,
                               device=x.device)
        return _license_scores(x)

    def detect(self, frames_u8, cf, spec, positions=None):
        frames = torch.as_tensor(frames_u8)
        sc = self.score_map(frames)
        n, h, w = frames.shape
        pos = _positions(cf, spec) if positions is None else positions
        hits = _grid_hits(sc > self.threshold, 2, 5, h, w, cf.crop,
                          self.qgrid)
        return {("plate", _bucket(pos[t], spec), int(a), int(b))
                for t, a, b in hits}


# ---------------------------------------------------------------------------
# OCR: digit reading inside detected plate regions
# ---------------------------------------------------------------------------

def _glyph_templates() -> np.ndarray:
    g = digit_glyphs()
    return g - g.mean(axis=(1, 2), keepdims=True)


def _read_plates(patches: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(m, 9, 26) plate patches -> per patch the 4 digits read and their
    correlation confidences, both (m, 4): each 7x5 digit cell (dark on
    white) correlated with the zero-mean glyph templates."""
    glyphs = _on(patches.device, "glyphs")                     # (10, 7, 5)
    cells = torch.stack([patches[:, 1:8, 1 + s * 6:6 + s * 6]
                         for s in range(4)], dim=1)            # (m, 4, 7, 5)
    cells = 1.0 - cells  # digits are dark on white
    cells = cells - cells.mean(dim=(2, 3), keepdim=True)
    nrm = torch.linalg.vector_norm(cells, dim=(2, 3)) + 1e-6   # (m, 4)
    gn = torch.linalg.vector_norm(glyphs, dim=(1, 2)) + 1e-6   # (10,)
    corr = (glyphs[None, None] * cells[:, :, None]).sum(dim=(3, 4))
    corr = corr / (nrm[:, :, None] * gn)                       # (m, 4, 10)
    conf, digit = corr.max(dim=2)
    return digit.cpu().numpy(), conf.cpu().numpy()


class OCR(Operator):
    name = "ocr"
    conf = 0.55
    _detector = License()

    def _candidates(self, sc: torch.Tensor) -> list[tuple[int, int]]:
        """(frame, flat index) of the up-to-3 best plate scores above the
        detector threshold in each frame, best first; equal scores rank the
        larger index first (the order a stable ascending sort, read
        backwards, gives).  Only the few hits at or above each frame's
        third-best score leave the device."""
        flat = sc.reshape(sc.shape[0], -1)
        kth = torch.topk(flat, min(3, flat.shape[1]), dim=1).values[:, -1:]
        t, o = ((flat >= kth) & (flat > self._detector.threshold)
                ).nonzero(as_tuple=True)
        vals = flat[t, o].cpu().numpy()
        by_frame: dict[int, list] = {}
        for ti, oi, v in zip(t.cpu().numpy(), o.cpu().numpy(), vals):
            by_frame.setdefault(int(ti), []).append((-float(v), -int(oi)))
        out = []
        for ti in sorted(by_frame):
            out += [(ti, -neg_o) for _v, neg_o in sorted(by_frame[ti])[:3]]
        return out

    def detect(self, frames_u8, cf, spec, positions=None):
        frames = _unit_float(frames_u8)
        sc = self._detector.score_map(frames_u8)
        n, h, w = frames.shape
        pos = _positions(cf, spec) if positions is None else positions
        if sc.numel() == 0:
            return set()
        sw = sc.shape[2]
        # plate canonical size at ingest scale
        ph = max(4, int(round(9 * h / 96)))
        pw = max(8, int(round(26 * w / 160)))
        picks = []
        for t, o in self._candidates(sc):
            iy, ix = divmod(o, sw)
            py, px = iy + 2, ix + 5  # plate center-ish in frame coords
            y0, x0 = py - ph // 2, px - pw // 2
            if y0 < 0 or x0 < 0 or y0 + ph > h or x0 + pw > w:
                continue
            picks.append((t, y0, x0))
        if not picks:
            return set()
        dev = frames.device
        p = torch.as_tensor(np.asarray(picks, np.int64), device=dev)
        rows = p[:, 1:2] + torch.arange(ph, device=dev)[None]   # (m, ph)
        cols = p[:, 2:3] + torch.arange(pw, device=dev)[None]   # (m, pw)
        patches = frames[p[:, 0, None, None], rows[:, :, None], cols[:, None]]
        # extract patches scaled to the canonical 9x26 plate
        digits, confs = _read_plates(T.resize(patches, 9, 26))
        items = set()
        for (t, _y0, _x0), dg, cs in zip(picks, digits, confs):
            if np.mean([float(c) for c in cs]) > self.conf:
                items.add(("ocr", _bucket(pos[t], spec),
                           "".join(map(str, dg.tolist()))))
        return items


_CONSTS = {"snn": _snn_kernels, "nn": _nn_templates,
           "glyphs": _glyph_templates}

OPERATORS: dict[str, Operator] = {
    op.name: op for op in (Diff(), Motion(), SNN(), NN(), License(), OCR())
}
