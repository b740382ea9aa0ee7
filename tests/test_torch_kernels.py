"""The port's CUDA kernels (K1 dct8_dequantize, K2 resize_bilinear,
K3 dct8_quantize and its encoder form dct8_encode_chunks, K4
flash_attention, K5 mamba_scan, K6 rglru_scan and its gated form
rglru_gated_scan) against their plain PyTorch versions.

This file imports neither ``jax`` nor ``repro``, so it also runs on a GPU
host that has PyTorch but no JAX.  On the CPU it checks what the kernels
receive (the wrappers refuse CPU tensors, ``ops`` routes them to the plain
versions, ``apply_quality`` is the standalone K3's then K1's plain
version, K2's banded taps reproduce the dense weights, K5's and K6's
plain scans carry their state across a split, K6's gated form is the
mixer's stepped ops plus the plain scan and its mutants fail the hold,
K5's kernel arithmetic --
the decay as 2^(delta·a·log2 e), one fma a state, y summed over lanes in
butterfly order -- holds its 1e-5 bound where its input-level mutants
fail it, K4's decode form is a row
of its prefill form, capped and windowed too, its window keeps each row's
last keys, its non-causal form, mixed dtypes and a misplaced decode
window are refused where no path takes them, its decode form's split
plan covers every key once with the same grid at every length, and its
bf16 prefill form's rounding -- raw bf16 q·k scaled in f32, p split in
bf16 hi + lo -- holds ``ref.HOLD`` where p rounded once or q scaled in
bf16 would not); the
tests marked ``cuda`` launch the kernels (and run the operators, the
reduced Falcon-Mamba, a reduced StarCoder2, a reduced RecurrentGemma, a
reduced HuBERT and a reduced Gemma2 on the card) and skip without a card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""

import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analytics import operators as O
from repro_torch.analytics.operators import OPERATORS
from repro_torch.analytics.scene import generate_segment
from repro_torch.codec import segment as S
from repro_torch.codec import transform as T
from repro_torch.core.knobs import FidelityOption, IngestSpec
from repro_torch.kernels.attention import attention as K4
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import (attention_ref, hold_ratio,
                                               scores_over_cap)
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.dct8 import dct8 as K13
from repro_torch.kernels.dct8 import ops as dct_ops
from repro_torch.kernels.dct8.ref import (ENCODE_MUTANTS,
                                          dct8_dequantize_ref,
                                          dct8_encode_chunks_ref,
                                          dct8_quantize_ref,
                                          encode_chunks_stepped,
                                          encode_inputs, encode_mutant,
                                          k3_holds)
from repro_torch.kernels.mamba_scan import mamba_scan as K5
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import (MUTANTS as SCAN_MUTANTS,
                                                mamba_scan_ref, mutant_inputs)
from repro_torch.kernels.resize import ops as resize_ops
from repro_torch.kernels.resize import resize as K2
from repro_torch.kernels.resize.ref import resize_ref
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.kernels.rglru import rglru as K6
from repro_torch.kernels.rglru.ref import (GATED_MUTANTS, gate_arrays,
                                          gated_ab, gated_mutant,
                                          rglru_gated_scan_ref, rglru_scan_ref)

#: K6 vs its plain version, of max(1, max |h|): both round each step once,
#: but the plain version's float64 step rounds twice on its way to float32
#: where a float64 sum lands on a float32 tie -- a one-ulp step that decays
#: with a < 1.  2^-20 leaves room for a few such ulps.
LRU_TOL = 2 ** -20

# main-path shapes at the 96x160 and 720p specs (SF -> CF grids, NN's
# pyramid, OCR's plate patch), an upscale, a one-axis resize, identity
RESIZES = [(96, 160, 72, 120), (96, 160, 64, 106), (72, 120, 56, 88),
           (27, 78, 9, 26), (36, 60, 96, 160), (96, 160, 96, 120),
           (64, 64, 14, 14), (9, 26, 9, 26), (720, 1280, 544, 960),
           (544, 960, 96, 176), (68, 208, 9, 26)]

# K2 cases (n, h1, w1, h2, w2) beyond RESIZES, where its tiles are ragged,
# narrowed or wide
RESIZE_EDGES = [
    (3, 50, 300, 37, 203),     # ragged last tiles in both axes
    (2, 9, 26, 40, 150),       # an upscale, ragged in both axes
    (1, 544, 960, 96, 176),    # one frame, bands of 12 and 11 taps
    (1, 960, 544, 176, 96),    # the same bands the other way round
    (500, 68, 208, 9, 26),     # several hundred plate patches
    (4, 64, 2000, 20, 100),    # a band that narrows the tile
    (2, 40, 5000, 8, 90)]      # one that opts in to more shared memory

# (n_in, n_out) of one axis beyond RESIZES for K2's tile plan: the widest
# bands the port calls (960 -> 176: 11 taps, 544 -> 96: 12), upscales, one
# input or output, a 2/3 pyramid level, bands that narrow the tile (2000 ->
# 100) and one that opts in to more shared memory (5000 -> 90)
PLAN_PAIRS = [(960, 176), (544, 96), (9, 26), (26, 160), (60, 161),
              (1, 7), (7, 1), (1280, 1), (1280, 853), (1279, 640),
              (2000, 100), (5000, 90), (3840, 211)]


def test_wrappers_take_only_cuda_tensors_and_ops_route_by_device():
    """A wrapper never falls back: a CPU tensor is refused; the dispatch in
    ``ops`` sends CPU tensors to the plain versions instead."""
    x = torch.rand(2, 16, 24) * 255
    with pytest.raises(ValueError, match="CUDA"):
        K13.dct8_quantize(x, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        K13.dct8_dequantize(torch.zeros(1, 2, 3, 8, 8, dtype=torch.int16), 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        K2.resize_bilinear(x, 8, 12)
    sym = dct8_quantize_ref(x, 2.0)
    assert torch.equal(dct_ops.dct_dequantize(sym, 2.0),
                       dct8_dequantize_ref(sym, 2.0))
    f = x.to(torch.uint8)
    assert torch.equal(dct_ops.dct_encode_chunks(f, 1, 2.0),
                       dct8_encode_chunks_ref(f, 1, 2.0))
    assert torch.equal(resize_ops.resize(x, 8, 12), resize_ref(x, 8, 12))


@pytest.mark.parametrize("h1,w1,h2,w2", RESIZES)
def test_resize_band_reproduces_dense_weights(h1, w1, h2, w2):
    """The banded taps K2 receives are the dense matrix, row for row, and
    a tap loop over them (the kernel's arithmetic) gives the plain
    product."""
    for n_out, n_in in ((h2, h1), (w2, w1)):
        m = K2.interp_matrix(n_out, n_in)
        start, wts = K2.band(n_out, n_in)
        taps = wts.shape[1]
        assert taps <= 2 * math.ceil(max(1.0, n_in / n_out)) + 1
        assert (start >= 0).all() and (start + taps <= n_in).all()
        dense = np.zeros_like(m)
        for i in range(n_out):
            dense[i, start[i]:start[i] + taps] = wts[i]
        assert np.array_equal(dense, m)
        np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-6)
    rng = np.random.default_rng(1)
    x = (rng.random((2, h1, w1)) * 255).astype(np.float32)
    y0, wy = K2.band(h2, h1)
    x0, wx = K2.band(w2, w1)
    out = np.zeros((2, h2, w2), np.float32)
    for b in range(wx.shape[1]):
        cols = x[:, :, x0 + b]                             # (2, h1, w2)
        v = sum(wy[None, :, a, None] * cols[:, y0 + a, :]
                for a in range(wy.shape[1]))
        out += wx[None, None, :, b] * v
    np.testing.assert_allclose(
        out, resize_ref(torch.from_numpy(x), h2, w2).numpy(), atol=1e-3)


def _check_tiles(start, taps, width, span):
    """``start`` (a band's starts) is non-decreasing, and each tile of
    ``width`` outputs finds every tap of every output in the ``span``
    inputs from its first output's start."""
    assert (np.diff(start) >= 0).all()
    for j0 in range(0, len(start), width):
        tile = start[j0:j0 + width]
        assert tile.min() == start[j0]
        assert tile.max() + taps - start[j0] <= span


def _check_tile_plan(n_out, n_in):
    """K2's column tile over ``band(n_out, n_in)``: it covers every tap,
    and its shared memory is its rows of sums and within the block's
    most; above the default only where the tile is at its narrowest."""
    start, wts = K2.band(n_out, n_in)
    tw, span, smem = K2.tile_plan(n_out, n_in, wts.shape[1])
    _check_tiles(start, wts.shape[1], tw, span)
    assert smem == K2.TILE_ROWS * span * 4 <= K2.SMEM_MAX
    assert smem <= K2.SMEM_DEFAULT or tw == K2.THREADS // K2.TILE_ROWS
    return tw, smem


@pytest.mark.parametrize("h1,w1,h2,w2", RESIZES)
def test_resize_tile_plan_covers_every_tap(h1, w1, h2, w2):
    """At every shape the port calls, K2's tiles cover their taps: a tile's
    rows read the input rows from its first row's start, its columns'
    sums fit the planned span, and the block's shared memory fits the
    default 48 KB, so no launch opts in to more."""
    y0, wy = K2.band(h2, h1)
    _check_tiles(y0, wy.shape[1], K2.TILE_ROWS,
                 y0[-1] + wy.shape[1] - y0[0])
    _, smem = _check_tile_plan(w2, w1)
    assert smem <= K2.SMEM_DEFAULT


@pytest.mark.parametrize("n_in,n_out", PLAN_PAIRS)
def test_resize_tile_plan_holds_beyond_the_port_shapes(n_in, n_out):
    """The plan's span bounds the band's rise at any (n_in, n_out) pair:
    downscales to 1/55, upscales, single rows and columns, and bands that
    narrow the tile or opt in to more shared memory."""
    tw, smem = _check_tile_plan(n_out, n_in)
    if (n_in, n_out) == (2000, 100):
        assert tw < K2.TILE_COLS and smem <= K2.SMEM_DEFAULT
    if (n_in, n_out) == (5000, 90):
        assert smem > K2.SMEM_DEFAULT


def test_resize_tile_constants_are_the_sources():
    """``tile_plan``'s constants are those ``csrc/resize.cu`` is built
    with."""
    import os
    import re

    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, "resize.cu")) as f:
        src = f.read()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src)[1]
        return math.prod(int(t) for t in expr.split("*"))

    assert (const("kTH"), const("kTW"), const("kThreads")) == (
        K2.TILE_ROWS, K2.TILE_COLS, K2.THREADS)
    assert (const("kSmemDefault"), const("kSmemMax")) == (
        K2.SMEM_DEFAULT, K2.SMEM_MAX)


def _scan_inputs(bsz, s, inner, n, dtype=torch.float32, seed=0,
                 with_h0=False, device="cpu", a_kind="init"):
    """K5's inputs as the Mamba mixer gives them: softplus steps (float32
    there, as the mixer's bias is), silu'd activations and B/C rows in
    ``dtype``, and optionally a non-zero initial state; ``a`` as
    initialised, ``-(1..n)`` per channel (``a_kind`` "init"), or
    ``-exp(u)`` with u uniform in [log 0.05, log 50] per (channel, state)
    ("drawn"), so that no power of one decay gives the others."""
    g = torch.Generator().manual_seed(seed)
    delta = torch.nn.functional.softplus(
        torch.randn((bsz, s, inner), generator=g) - 2.0)
    xc = torch.nn.functional.silu(torch.randn((bsz, s, inner), generator=g))
    bmat = torch.randn((bsz, s, n), generator=g)
    cmat = torch.randn((bsz, s, n), generator=g)
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(inner, 1)
    h0 = torch.randn((bsz, inner, n), generator=g) if with_h0 else None
    if a_kind == "drawn":
        a = -torch.exp(torch.empty((inner, n)).uniform_(
            math.log(0.05), math.log(50.0), generator=g))
    out = [delta, xc.to(dtype), bmat.to(dtype), cmat.to(dtype), a, h0]
    return [None if t is None else t.to(device) for t in out]


#: K5 against its plain version: y and the final state within 1e-5 of
#: their largest |value| (at least 1); the two sum the C-contraction in
#: different orders and round the decay apart
SCAN_TOL = 1e-5


def _scan_holds(got, want) -> bool:
    """``got`` (y, h_T) within ``SCAN_TOL`` of ``want``, both parts (y of
    S 0 has no element and holds when its shape does)."""
    return all(g.shape == w.shape and (
        w.numel() == 0 or float((g.float() - w.float()).abs().max())
        <= SCAN_TOL * max(1.0, float(w.float().abs().max())))
        for g, w in zip(got, want))


def _scan_in_kernel_order(delta, xc, bmat, cmat, a, h0=None,
                          lanes=K5.LANES):
    """K5 as its kernel rounds it, in plain torch: a2 = a·log2(e) and
    d·a2 in f32, the decay 2^(d·a2) exact in float64 and rounded to f32,
    subnormals flushed to zero (the card's ``ex2.approx.ftz`` is about 2
    ulp off that, which only the card test sees); dx = delta·xc and
    dbx = dx·b in f32; h = da·h + dbx as one fma (product and sum in
    float64, rounded once to f32); y as ``lanes`` partial sums, each over
    its n / lanes states in order (a product, then fmas), added in
    butterfly order (``__shfl_xor_sync`` at offsets 1, 2, ...)."""
    bsz, s, inner = delta.shape
    n = a.shape[-1]
    sl = n // lanes
    a2 = a.float() * torch.tensor(math.log2(math.e), dtype=torch.float32)
    h = (torch.zeros((bsz, inner, n)) if h0 is None else h0.float())
    y = torch.empty((bsz, s, inner))
    for t in range(s):
        d = delta[:, t].float()
        da = torch.exp2((d[..., None] * a2).double()).float()
        da = torch.where(da < 2.0 ** -126, torch.zeros_like(da), da)
        dbx = (d * xc[:, t].float())[..., None] * bmat[:, t].float()[:, None]
        h = (da.double() * h.double() + dbx.double()).float()
        hl = h.reshape(bsz, inner, lanes, sl)
        cl = cmat[:, t].float().reshape(bsz, 1, lanes, sl)
        p = hl[..., 0] * cl[..., 0]
        for j in range(1, sl):
            p = (hl[..., j].double() * cl[..., j].double()
                 + p.double()).float()
        off = 1
        while off < lanes:
            p = p + p[..., torch.arange(lanes) ^ off]
            off *= 2
        y[:, t] = p[..., 0]
    return y, h


def test_mamba_scan_wrapper_refuses_cpu_and_ops_routes_to_plain():
    """K5's wrapper never falls back: CPU tensors and state sizes it is not
    built for are refused; ``ops`` sends CPU tensors to the plain scan."""
    args = _scan_inputs(2, 5, 12, 8, with_h0=True)
    with pytest.raises(ValueError, match="CUDA"):
        K5.mamba_scan(*args)
    with pytest.raises(ValueError, match="state sizes"):
        K5.mamba_scan(*_scan_inputs(1, 2, 4, 3))
    y, h = scan_ops.selective_scan(*args)
    y_ref, h_ref = mamba_scan_ref(*args)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert y.dtype == h.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_plain_carries_state_across_a_split(dtype):
    """Scanning S steps at once equals scanning a prefix and then the rest
    from the prefix's final state -- the prefill/decode hand-off -- and
    an absent initial state equals a zero one."""
    delta, xc, b, c, a, h0 = _scan_inputs(2, 9, 16, 8, dtype, seed=3,
                                          with_h0=True)
    y, h = mamba_scan_ref(delta, xc, b, c, a, h0)
    y1, h1 = mamba_scan_ref(delta[:, :6], xc[:, :6], b[:, :6], c[:, :6], a,
                            h0)
    y2, h2 = mamba_scan_ref(delta[:, 6:], xc[:, 6:], b[:, 6:], c[:, 6:], a,
                            h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)
    y0, _ = mamba_scan_ref(delta, xc, b, c, a)
    assert torch.equal(y0, mamba_scan_ref(delta, xc, b, c, a,
                                          torch.zeros_like(h0))[0])


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("a_kind", ["init", "drawn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_rounding_in_kernel_order_holds(n, a_kind, dtype):
    """The kernel's arithmetic (``_scan_in_kernel_order``: the decay as
    2^(d·(a·log2 e)), the state as one fma, y summed over lanes in
    butterfly order) holds ``SCAN_TOL`` against the plain version over
    2,048 steps, a from the initialisation and drawn per (channel,
    state), xc in f32 and bf16.  It shows the change of order and the
    pre-scaling only, not the error of the card's ex2.approx."""
    args = _scan_inputs(2, 2048, 3, n, dtype, seed=n + len(a_kind),
                        with_h0=True, a_kind=a_kind)
    assert _scan_holds(_scan_in_kernel_order(*args), mamba_scan_ref(*args))


@pytest.mark.parametrize("mutant", SCAN_MUTANTS)
@pytest.mark.parametrize("a_kind", ["init", "drawn"])
def test_scan_hold_fails_input_mutants(mutant, a_kind):
    """Each input-level mutant of ``SCAN_MUTANTS`` run through the plain
    version fails ``SCAN_TOL`` against the kernel's arithmetic on the
    true inputs, as the card test and chip_smoke.py ask of the kernel."""
    args = _scan_inputs(2, 300, 3, 16, torch.bfloat16, seed=5,
                        with_h0=True, a_kind=a_kind)
    bad = mamba_scan_ref(*mutant_inputs(mutant, *args))
    assert not _scan_holds(_scan_in_kernel_order(*args), bad)


def _attn_inputs(bsz, sq, sk, h, kvh, hd, dtype=torch.float32, seed=0,
                 device="cpu"):
    """q (bsz, sq, h, hd), k, v (bsz, sk, kvh, hd) from a seed, in
    ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    out = [torch.randn(shape, generator=g).to(dtype)
           for shape in ((bsz, sq, h, hd), (bsz, sk, kvh, hd),
                         (bsz, sk, kvh, hd))]
    return [t.to(device) for t in out]


def test_attention_wrapper_refuses_cpu_and_ops_routes_to_plain():
    """K4's wrapper never falls back: CPU tensors, head dims it is not
    built for, a decode group wider than one block serves and a prefill
    form at an offset or over part of its keys are refused; ``ops`` sends
    CPU tensors to the plain version."""
    q, k, v = _attn_inputs(2, 5, 5, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        K4.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        K4.flash_attention(*_attn_inputs(1, 3, 3, 2, 1, 48))
    with pytest.raises(ValueError, match="decode form"):
        K4.flash_attention(*_attn_inputs(1, 1, 3, 34, 2, 64))
    with pytest.raises(ValueError, match="k_len"):
        K4.flash_attention(q, k, v, k_len=6)
    with pytest.raises(ValueError, match="prefill form"):
        K4.flash_attention(q, k, v, 1)
    with pytest.raises(ValueError, match="prefill form"):
        K4.flash_attention(q, k, v, k_len=4)
    with pytest.raises(ValueError, match="last valid position"):
        K4.flash_attention(q[:, :1], k, v, 2, 4, window=2)
    with pytest.raises(ValueError, match="window is >= 0"):
        K4.flash_attention(q, k, v, window=-1)
    assert torch.equal(attn_ops.gqa_attention(q, k, v),
                       attention_ref(q, k, v))
    assert torch.equal(attn_ops.gqa_attention(q, k, v, window=2),
                       attention_ref(q, k, v, window=2))
    assert torch.equal(attn_ops.gqa_attention(q[:, :1], k, v, 3, 4),
                       attention_ref(q[:, :1], k, v, 3, 4))
    assert torch.equal(attn_ops.gqa_attention(q[:, :1], k, v, 3, 4, 2),
                       attention_ref(q[:, :1], k, v, 3, 4, 2))


def test_attention_capped_mixed_and_windowed_decode_forms_are_checked():
    """The soft-cap, the decode form's window and a float32 query over a
    bfloat16 cache: the wrapper refuses what the C entry refuses (a
    negative cap, mixed dtypes in the prefill form or as a bfloat16 query
    over a float32 cache) before it looks at the device, takes head_dim 32
    in both forms, counts each capped form under its own key; ``ops``
    sends CPU tensors to the plain version with the arguments passed
    through."""
    q, k, v = _attn_inputs(2, 6, 6, 4, 2, 32)
    with pytest.raises(ValueError, match="logit_cap"):
        K4.flash_attention(q, k, v, logit_cap=-1.0)
    with pytest.raises(ValueError, match="decode form only"):
        K4.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="decode form only"):
        K4.flash_attention(q[:, :1].bfloat16(), k, v, 5, 6)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K4.flash_attention(q[:, :1], k.half(), v.half(), 5, 6)
    for args in ((q,), (q[:, :1], 5, 6, 3)):  # hd 32: both forms
        with pytest.raises(ValueError, match="CUDA"):
            K4.flash_attention(*args[:1], k, v, *args[1:], logit_cap=50.0)
    with pytest.raises(ValueError, match="CUDA"):  # an f32 q over bf16 k/v
        K4.flash_attention(q[:, :1], k.bfloat16(), v.bfloat16(), 5, 6, 3)
    assert (K4.launch_key(), K4.launch_key(causal=False)) == (
        "flash_attention", K4.NONCAUSAL)
    assert K4.launch_key(window=2, logit_cap=50.0) == K4.CAPPED_WINDOWED
    assert K4.launch_key(logit_cap=50.0) == K4.CAPPED
    got = attn_ops.gqa_attention(q[:, :1], k.bfloat16(), v.bfloat16(), 5, 6,
                                 3, logit_cap=2.0)
    assert got.dtype == torch.float32
    assert torch.equal(got, attention_ref(q[:, :1], k.bfloat16(),
                                          v.bfloat16(), 5, 6, 3,
                                          logit_cap=2.0))
    assert not torch.equal(got, attention_ref(q[:, :1], k.bfloat16(),
                                              v.bfloat16(), 5, 6, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_plain_capped_decode_form_is_a_row_of_the_prefill(dtype):
    """With a soft-cap and a window, query row t of the prefill form equals
    the decode form of that row over a cache whose first ``t + 1``
    positions are valid (gemma2's local layer, in prefill and in a decode
    step); and its scores exceed the cap (``scores_over_cap``), so the
    uncapped row differs."""
    q, k, v = _attn_inputs(2, 40, 48, 4, 2, 32, dtype, seed=9)
    k = scores_over_cap(q, k, 50.0).to(dtype)
    full = attention_ref(q, k[:, :40], v[:, :40], window=12, logit_cap=50.0)
    for t in (0, 11, 12, 39):
        row = attention_ref(q[:, t:t + 1], k, v, t, t + 1, window=12,
                            logit_cap=50.0)
        torch.testing.assert_close(row, full[:, t:t + 1], atol=1e-6, rtol=0)
    assert not torch.equal(
        full, attention_ref(q, k[:, :40], v[:, :40], window=12))


def test_attention_noncausal_form_is_refused_where_no_path_takes_it():
    """The non-causal form is a prefill form over all keys with no window:
    K4's wrapper refuses it at Sq 1, with a window and at an offset, and
    refuses head_dim 80 (HuBERT's, a prefill-only head dim) in the decode
    form, before it looks at the device; ``ops`` sends CPU tensors to the
    plain version with the flag passed through."""
    q, k, v = _attn_inputs(2, 5, 5, 4, 2, 80)
    with pytest.raises(ValueError, match="non-causal"):
        K4.flash_attention(q[:, :1], k, v, 4, 5, causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        K4.flash_attention(q, k, v, window=2, causal=False)
    with pytest.raises(ValueError, match="prefill form"):
        K4.flash_attention(q, k, v, k_len=4, causal=False)
    with pytest.raises(ValueError, match="decode form is built"):
        K4.flash_attention(q[:, :1], k, v, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        K4.flash_attention(q, k, v, causal=False)
    got = attn_ops.gqa_attention(q, k, v, causal=False)
    assert torch.equal(got, attention_ref(q, k, v, causal=False))
    assert not torch.equal(got, attention_ref(q, k, v))
    assert 80 in K4.HEAD_DIMS and 80 not in K4.DECODE_HEAD_DIMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_plain_decode_form_is_a_row_of_the_prefill_form(dtype):
    """Query row t of the causal prefill over S keys equals the decode
    form: that row alone at ``q_offset = t`` over a cache whose first
    ``t + 1`` positions are valid (the rest hold other values); and a
    chunk of rows at an offset equals the same rows of the full form."""
    q, k, v = _attn_inputs(2, 9, 12, 6, 2, 16, dtype, seed=4)
    full = attention_ref(q, k[:, :9], v[:, :9])
    for t in (0, 4, 8):
        row = attention_ref(q[:, t:t + 1], k, v, q_offset=t, k_len=t + 1)
        torch.testing.assert_close(row, full[:, t:t + 1], atol=1e-6, rtol=0)
    chunk = attention_ref(q[:, 5:], k, v, q_offset=5, k_len=9)
    torch.testing.assert_close(chunk, full[:, 5:], atol=1e-6, rtol=0)
    assert full.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_plain_window_keeps_each_rows_last_keys(dtype):
    """With a window, query row t of the prefill form equals the decode
    form of that row over keys t - window + 1 .. t alone; without one the
    row differs once it has more keys than the window."""
    q, k, v = _attn_inputs(2, 40, 40, 4, 1, 16, dtype, seed=8)
    win = attention_ref(q, k, v, window=12)
    full = attention_ref(q, k, v)
    for t in (0, 11, 12, 39):
        lo = max(0, t - 11)
        row = attention_ref(q[:, t:t + 1], k[:, lo:t + 1], v[:, lo:t + 1],
                            q_offset=t - lo, k_len=t + 1 - lo)
        torch.testing.assert_close(win[:, t:t + 1], row, atol=1e-6, rtol=0)
    assert torch.equal(win[:, :12], full[:, :12])
    assert not torch.equal(win[:, 12:], full[:, 12:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_hold_passes_rounding_and_fails_a_wrong_key_tile(dtype):
    """The rule K4 is held to against its plain version: outputs one bf16
    ulp apart (each element nudged to its neighbour) or a few float32 eps
    of the row apart pass; the same attention with the values of one
    middle 64-key tile zeroed fails, though its error is far below the
    largest |output| -- without a window, and with a window of 96 keys
    (the tile inside the window of rows 128..255)."""
    q, k, v = _attn_inputs(2, 256, 256, 4, 2, 64, dtype, seed=6)
    v_bad = v.clone()
    v_bad[:, 128:192] = 0
    for window in (0, 96):
        want = attention_ref(q, k, v, window=window)
        if dtype == torch.bfloat16:
            near = (want.view(torch.int16) + 1).view(torch.bfloat16)
        else:
            rms = want.square().mean(dim=-1, keepdim=True).sqrt()
            near = want + 8 * torch.finfo(dtype).eps * rms
        assert not torch.equal(near, want) and hold_ratio(near, want) <= 1
        bad = attention_ref(q, k, v_bad, window=window)
        assert float((bad - want).abs().max()) < \
            0.5 * float(want.abs().max())
        assert hold_ratio(bad, want) > 1, window


def _tensor_core_prefill(q, k, v, scheme, window=0, causal=True,
                         logit_cap=0.0):
    """K4's bf16 prefill form as its tensor-core kernel rounds it, in plain
    torch over whole rows (the kernel's online softmax reorders only f32
    sums, which ``ref.HOLD``'s r term covers).  ``scheme``: ``"split"``,
    the kernel's (raw bf16 q·k with an f32 result scaled by hd^-0.5 after,
    p in f32 split into hi = bf16(p) and lo = bf16(p - hi) for two products
    with v, summed in f32); ``"p once"``, p rounded to bf16 once before
    p·v (as SDPA and flex_attention do); ``"q scaled"``, q·hd^-0.5 rounded
    to bf16 before the product, then p split.  Returns o in bf16."""
    bsz, s, h, hd = q.shape
    kvh = k.shape[2]
    qf = q.float()
    if scheme == "q scaled":
        qf = (qf * hd ** -0.5).bfloat16().float()
    sc = torch.einsum("bqkgd,bpkd->bkgqp",
                      qf.reshape(bsz, s, kvh, h // kvh, hd), k.float())
    if scheme != "q scaled":
        sc = sc * hd ** -0.5
    if logit_cap:
        sc = logit_cap * torch.tanh(sc / logit_cap)
    pos = torch.arange(s)
    ok = pos[None, :] <= pos[:, None] if causal else torch.ones(
        s, s, dtype=torch.bool)
    if window:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    sc = torch.where(ok, sc, -1e30)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    parts = [hi] if scheme == "p once" else [hi, (p - hi).bfloat16().float()]
    pv = sum(torch.einsum("bkgqp,bpkd->bkgqd", part, v.float())
             for part in parts)
    o = pv / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(bsz, s, h, hd).bfloat16()


#: K4's prefill forms as (window, causal, logit_cap): a window narrower
#: than the tensor-core kernel's key tile (64 keys; 32 at hd 256) and one
#: across tiles; the capped forms over keys whose scores pass the cap in
#: every row (``scores_over_cap``)
PREFILL_FORMS = {"causal": (0, True, 0.0), "window 16": (16, True, 0.0),
                 "window 100": (100, True, 0.0), "non-causal": (0, False, 0.0),
                 "capped": (0, True, 50.0),
                 "capped, window 100": (100, True, 50.0)}


def _prefill_inputs(form, bsz, sq, h, kvh, hd, dtype, seed, device="cpu"):
    """q, k, v for ``PREFILL_FORMS[form]`` in ``dtype`` on ``device`` (the
    capped forms' by ``_capped_inputs``), and the form's keyword
    arguments."""
    window, causal, cap = PREFILL_FORMS[form]
    make = _capped_inputs if cap else _attn_inputs
    q, k, v = make(bsz, sq, sq, h, kvh, hd, dtype, seed, device=device)
    return q, k, v, dict(window=window, causal=causal, logit_cap=cap)


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("form", sorted(PREFILL_FORMS))
def test_bf16_prefill_rounding_holds_with_p_split_in_hi_and_lo(form, hd):
    """The tensor-core prefill form's rounding (``_tensor_core_prefill``,
    "split") holds ``ref.HOLD`` in bf16 in every prefill form at every head
    dim the kernel takes; the same with p rounded to bf16 once fails it."""
    q, k, v, kw = _prefill_inputs(form, 2, 256, 4, 2, hd, torch.bfloat16,
                                  seed=hd + len(form))
    want = attention_ref(q, k, v, **kw)
    assert hold_ratio(_tensor_core_prefill(q, k, v, "split", **kw), want) <= 1
    assert hold_ratio(_tensor_core_prefill(q, k, v, "p once", **kw), want) > 1


@pytest.mark.parametrize("hd", [32, 80, 128])
@pytest.mark.parametrize("form", sorted(PREFILL_FORMS))
def test_bf16_prefill_rounding_fails_with_q_scaled_in_bf16(form, hd):
    """Where hd^-0.5 is no power of two, q scaled and rounded to bf16
    before the product fails ``ref.HOLD`` even with p split, so the kernel
    scales the f32 score instead."""
    q, k, v, kw = _prefill_inputs(form, 2, 256, 4, 2, hd, torch.bfloat16,
                                  seed=hd + len(form))
    want = attention_ref(q, k, v, **kw)
    assert hold_ratio(_tensor_core_prefill(q, k, v, "q scaled", **kw),
                      want) > 1


#: cache shapes (B, Sk, KV) and SM counts for the decode form's split plan:
#: Gemma2-2B's, StarCoder2-3B's and RecurrentGemma-9B's cells on an H100
#: (132 SMs) and a PCIe H100 (114), the CPU tests' own small caches, a
#: batch that fills the card alone, a long cache on few rows
SPLIT_CACHES = [(2, 8192, 4, 132), (4, 2080, 2, 132), (2, 2048, 1, 132),
                (2, 8192, 4, 114), (3, 720, 2, 132), (2, 3000, 4, 132),
                (1, 1, 1, 132), (1, 63, 2, 132), (64, 100, 8, 132),
                (1, 100000, 1, 132), (2, 9000, 1, 132), (2, 5, 2, 1),
                (7, 4099, 3, 16)]


@pytest.mark.parametrize("bsz,sk,kvh,n_sm", SPLIT_CACHES)
def test_decode_splits_cover_each_live_key_once(bsz, sk, kvh, n_sm):
    """The decode form's split plan, for each window over a cache (none,
    shorter than the cache, longer): splits of at least ``MIN_SPLIT_LEN``
    keys; two blocks an SM where splits of that length allow as many,
    never a full row of splits more, one split when the batch fills that
    many blocks alone; and, from the window's first key, every key the
    query sees falls in exactly one split, at every length of the cache
    (the plan never sees it)."""
    for window in (0, 1, 64, 1000, sk + 5):
        span = min(sk, window) if window else sk
        n_split, split_len = K4.decode_splits(bsz, sk, kvh, window, n_sm)
        assert split_len >= K4.MIN_SPLIT_LEN
        assert n_split * split_len >= span
        blocks, aim = n_split * bsz * kvh, K4.SPLIT_BLOCKS_PER_SM * n_sm
        shortest = -(-span // K4.MIN_SPLIT_LEN)  # splits of 64 keys
        assert blocks >= aim or n_split == shortest
        assert blocks < aim + bsz * kvh
        if bsz * kvh >= aim:
            assert n_split == 1
        lengths = {1, 2, split_len - 1, split_len, split_len + 1, sk // 2,
                   sk - 1, sk}
        for length in sorted(lengths & set(range(1, sk + 1))):
            k_first = max(0, length - window) if window else 0
            owner = np.zeros(sk, dtype=int)
            for lo, hi in K4.decode_split_keys((n_split, split_len),
                                               length - 1, length, window):
                owner[lo:hi] += 1
            assert (owner[k_first:length] == 1).all()
            assert not owner[:k_first].any() and not owner[length:].any()


@pytest.mark.parametrize("bsz,sk,kvh,h,hd", [(2, 8192, 4, 8, 256),
                                             (4, 2080, 2, 24, 128),
                                             (2, 2048, 1, 16, 256),
                                             (1, 40, 2, 4, 32)])
def test_decode_wrapper_launches_one_grid_per_cache(monkeypatch, bsz, sk,
                                                     kvh, h, hd):
    """What K4's wrapper hands the C entry in the decode form, seen through
    a stand-in for the library (the card's own launch is a ``cuda`` test):
    the same split plan and the same float32 workspace of at least
    B·KV·n_split·G·(hd + 2) floats at every length of one cache and window
    (a capturable decode step), the plan being ``decode_splits`` of the
    cache's shape and the window, the workspace taken at most once and
    kept for the stream (another stream gets its own); every argument the
    ABI lists; no workspace with one split; one count a call in
    ``build.LAUNCHES``, under its form's key."""
    seen = []

    def entry(*args):
        assert len(args) == len(K4._ARGTYPES)
        seen.append(args)
        return 0

    monkeypatch.setattr(K4, "_kernel", lambda: entry)
    monkeypatch.setattr(K4, "_check", lambda *a: None)
    monkeypatch.setattr(K4, "sm_count", lambda index: 132)
    monkeypatch.setattr(K4, "_WORKSPACES", {})
    stream = {"cuda_stream": 0}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), dict(stream)))
    workspaces, empty = [], torch.empty

    def recorded_empty(*shape, **kw):
        workspaces.append((shape, kw.get("dtype")))
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", recorded_empty)
    q = torch.zeros((bsz, 1, h, hd))
    k = v = torch.zeros((bsz, sk, kvh, hd), dtype=torch.bfloat16)
    lengths = sorted({1, 2, min(sk, 65), sk // 2, sk - 1, sk})
    for window, cap in ((0, 0.0), (min(sk, 64), 50.0), (sk // 3, 50.0)):
        n_split, split_len = K4.decode_splits(bsz, sk, kvh, window, 132)
        seen.clear()
        workspaces.clear()
        LAUNCHES.reset()
        for length in lengths:
            K4.flash_attention(q, k, v, length - 1, length, window,
                               logit_cap=cap)
        assert LAUNCHES.snapshot() == {
            K4.launch_key(True, window, cap): len(lengths)}
        assert {args[-3:-1] for args in seen} == {(n_split, split_len)}
        want = bsz * kvh * n_split * (h // kvh) * (hd + 2)
        ptrs = {args[-4] for args in seen}
        if n_split == 1:
            assert ptrs == {None} and workspaces == []
        else:
            kept = K4._WORKSPACES[None, 0, threading.get_ident()]
            assert ptrs == {kept.data_ptr()} and kept.numel() >= want
            assert workspaces in ([], [((want,), torch.float32)])
    if len(K4._WORKSPACES) == 1:
        stream["cuda_stream"] = 1
        K4.flash_attention(q, k, v, sk - 1, sk)
        assert seen[-1][-4] == K4._WORKSPACES[
            None, 1, threading.get_ident()].data_ptr() != kept.data_ptr()
    K4.flash_attention(q.expand(bsz, 3, h, hd).contiguous(), k.float(),
                       v.float())
    assert seen[-1][-4:-1] == (None, 0, 0)  # the prefill form: no plan


def test_rglru_scan_wrapper_refuses_cpu_and_ops_routes_to_plain():
    """K6's wrapper never falls back: CPU tensors and types other than
    float32 are refused; ``ops`` sends CPU gates to the plain gated form,
    which is the plain scan of the gates' a and b."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 5, 12), generator=g)
    b = torch.randn((2, 5, 12), generator=g)
    h0 = torch.randn((2, 12), generator=g)
    with pytest.raises(ValueError, match="CUDA"):
        K6.rglru_scan(a, b, h0)
    with pytest.raises(ValueError, match="CUDA"):
        K6.rglru_scan(a.double(), b)
    r, i, xc, a_param, h0 = _gates(2, 5, 12, torch.float32, seed=0,
                                   with_h0=True)
    h = lru_ops.lru_gated_scan(r, i, xc, a_param, h0)
    assert h.dtype == torch.float32
    assert torch.equal(h, rglru_scan_ref(*gated_ab(r, i, xc, a_param), h0))


def test_rglru_plain_scan_carries_state_and_starts_from_zero():
    """Scanning S steps equals scanning a prefix and the rest from its
    last row (the prefill/decode hand-off), and an absent initial state
    equals a zero one."""
    g = torch.Generator().manual_seed(2)
    a, b = torch.rand((3, 9, 20), generator=g), torch.randn((3, 9, 20),
                                                             generator=g)
    h0 = torch.randn((3, 20), generator=g)
    h = rglru_scan_ref(a, b, h0)
    h1 = rglru_scan_ref(a[:, :4], b[:, :4], h0)
    h2 = rglru_scan_ref(a[:, 4:], b[:, 4:], h1[:, -1])
    assert torch.equal(torch.cat([h1, h2], dim=1), h)
    assert torch.equal(rglru_scan_ref(a, b),
                       rglru_scan_ref(a, b, torch.zeros_like(h0)))


def _gates(bsz, s, w, dtype, seed, with_h0=False):
    """K6's gated inputs (``gate_arrays``) as tensors: r, i and xc in
    ``dtype``, ``a_param`` float32, h0 float32 or None."""
    r, i, xc, a_param, h0 = (torch.from_numpy(x)
                             for x in gate_arrays(bsz, s, w, seed))
    return (*(g.to(dtype) for g in (r, i, xc)), a_param,
            h0 if with_h0 else None)


def _lru_hold(got, want) -> float:
    """max |got - want| over ``LRU_TOL`` of max(1, max |want|): the hold
    passes at 1 or less."""
    return float((got - want).abs().max()) / (
        LRU_TOL * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_gated_scan_routes_to_plain_equal_to_the_stepped_ops(
        dtype, with_h0):
    """On CPU tensors ``lru_gated_scan`` is the plain gated form, which
    equals, bit for bit, the RG-LRU mixer's stepped ops (a and b formed in
    PyTorch, as the mixer formed them before the gated form) followed by
    the plain scan, in bf16 and f32 gates, from zero and from a state."""
    r, i, xc, a_param, h0 = _gates(2, 37, 24, dtype, seed=5,
                                   with_h0=with_h0)
    got = lru_ops.lru_gated_scan(r, i, xc, a_param, h0)
    log_a = -8.0 * r * torch.nn.functional.softplus(a_param)
    a = torch.exp(log_a.to(torch.float32))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * xc).to(torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 37, 24)
    assert torch.equal(got, rglru_scan_ref(a, b, h0))
    assert torch.equal(got, rglru_gated_scan_ref(r, i, xc, a_param, h0))
    assert all(torch.equal(x, y) for x, y in zip(gated_ab(r, i, xc, a_param),
                                                 (a, b)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mutant", GATED_MUTANTS)
def test_rglru_gated_mutants_fail_the_hold(dtype, mutant):
    """Each of ``GATED_MUTANTS`` stands far outside the 2^-20 hold of the
    plain gated form -- from a state, at one step (the decode shape) and
    over 40 -- so the card's holds would catch a kernel with that
    defect."""
    for s in (1, 40):
        r, i, xc, a_param, h0 = _gates(2, s, 24, dtype, seed=s,
                                       with_h0=True)
        want = rglru_gated_scan_ref(r, i, xc, a_param, h0)
        bad = gated_mutant(mutant, r, i, xc, a_param, h0)
        assert _lru_hold(bad, want) > 100, (mutant, s)
    assert gated_mutant("h0 ignored", r, i, xc, a_param) is None


@pytest.mark.parametrize("case", ["cpu tensors", "float16 gates",
                                  "gate dtypes differ", "gate shapes differ",
                                  "a_param in bf16", "a_param's width",
                                  "h0's shape", "not (B, S, W)"])
def test_rglru_gated_scan_wrapper_refuses(case):
    """K6's gated form never falls back: CPU tensors are refused, and so,
    before the device is looked at, are gates in another dtype than f32 or
    bf16, gates whose dtypes or shapes differ, an ``a_param`` that is not
    (W,) float32, an h0 that is not (B, W) and inputs that are not 3-D."""
    r, i, xc, a_param, h0 = _gates(2, 5, 16, torch.bfloat16, seed=0,
                                   with_h0=True)
    match = {"cpu tensors": "CUDA", "float16 gates": "gates in",
             "gate dtypes differ": "i must be", "gate shapes differ":
             "xc must be", "a_param in bf16": "a_param must be",
             "a_param's width": "a_param must be", "h0's shape": "h0 must be",
             "not (B, S, W)": "takes"}[case]
    if case == "float16 gates":
        r, i, xc = (t.half() for t in (r, i, xc))
    elif case == "gate dtypes differ":
        i = i.float()
    elif case == "gate shapes differ":
        xc = xc[:, :4].contiguous()
    elif case == "a_param in bf16":
        a_param = a_param.bfloat16()
    elif case == "a_param's width":
        a_param = a_param[:8].contiguous()
    elif case == "h0's shape":
        h0 = h0[:1].contiguous()
    elif case == "not (B, S, W)":
        r = r[0]
    with pytest.raises(ValueError, match=match):
        K6.rglru_gated_scan(r, i, xc, a_param, h0)


# ---------------------------------------------------------------------------
# on the card
def _check_exact_division(dev):
    """Pixels scale to [0, 1] and hits map onto the item grid with the
    reference's true division: 204 / 255 is exactly 0.8 (License's
    brightness test) and 426.5 / 853 exactly 0.5 (a cell edge of NN's grid
    at the 2/3 level of a 1280-wide frame)."""
    u8 = torch.arange(256, dtype=torch.uint8, device=dev)
    want = np.arange(256, dtype=np.float32) / np.float32(255)
    assert np.array_equal(O._unit_float(u8).cpu().numpy(), want)
    mask = torch.zeros((1, 1, 853), dtype=torch.bool, device=dev)
    mask[0, 0, 420] = True
    assert O._grid_hits(mask, 6, 6, 480, 853, 1.0, 8).tolist() == [[0, 0, 4]]


def test_operators_divide_exactly_on_cpu():
    _check_exact_division(torch.device("cpu"))


# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 8), (3, 24, 48), (2, 720, 1280)])
@pytest.mark.parametrize("qs", [1.0, 6.0, 16.0])
def test_dct8_kernels_match_plain_on_card(cuda, shape, qs):
    """K3's symbols equal the plain version's (both sum in the same
    order; at most 1e-6 of them may differ by one where the plain
    version's float64 emulation of a fused multiply-add rounds twice);
    K1 within 1e-3, the reference's own Pallas-vs-jnp bound."""
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(shape, generator=g) * 40).round().to(cuda)
    sym = K13.dct8_quantize(x, qs)
    assert k3_holds(sym, dct8_quantize_ref(x, qs))[0]
    torch.testing.assert_close(K13.dct8_dequantize(sym, qs),
                               dct8_dequantize_ref(sym, qs), atol=1e-3,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,k", [(13, 48, 64, 5), (6, 16, 24, 1),
                                     (60, 544, 960, 10),
                                     (120, 720, 1280, 250)])
def test_encoder_form_equals_stepped_route_on_card(cuda, n, h, w, k):
    """K3's encoder form runs K3's and K1's row bodies, so its symbols
    equal the stepped route's (the standalone K3 and K1 kernels, torch's
    add and clamp) symbol for symbol; against the plain version it holds
    K3's bound.  The shapes: a ragged tail, every frame intra, the fast
    and the golden segment."""
    f = encode_inputs(n, h, w, seed=n + k, device=cuda)
    got = K13.dct8_encode_chunks(f, k, 2.0)
    stepped = encode_chunks_stepped(f, k, 2.0, K13.dct8_quantize,
                                    K13.dct8_dequantize)
    assert int((got != stepped).sum()) == 0
    assert k3_holds(got, dct8_encode_chunks_ref(f, k, 2.0))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", ENCODE_MUTANTS)
def test_encoder_form_differs_from_each_mutant_on_card(cuda, mutant):
    f = encode_inputs(13, 48, 64, seed=5, device=cuda)
    got = K13.dct8_encode_chunks(f, 5, 2.0)
    assert not k3_holds(got, encode_mutant(mutant, f, 5, 2.0))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("h1,w1,h2,w2", RESIZES)
def test_resize_kernel_matches_plain_on_card(cuda, h1, w1, h2, w2):
    g = torch.Generator().manual_seed(h1)
    x = (torch.rand((3, h1, w1), generator=g) * 255).to(cuda)
    torch.testing.assert_close(K2.resize_bilinear(x, h2, w2),
                               resize_ref(x, h2, w2), atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h1,w1,h2,w2", RESIZE_EDGES)
def test_resize_kernel_edges_on_card(cuda, n, h1, w1, h2, w2):
    """K2 within its 1e-3 of the plain version where its tiles are ragged,
    narrowed or wide, in exactly one launch a call."""
    g = torch.Generator().manual_seed(n + w1)
    x = (torch.rand((n, h1, w1), generator=g) * 255).to(cuda)
    LAUNCHES.reset()
    got = K2.resize_bilinear(x, h2, w2)
    assert LAUNCHES.snapshot() == {"resize_bilinear": 1}
    torch.testing.assert_close(got, resize_ref(x, h2, w2), atol=1e-3,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out", PLAN_PAIRS + [
    (w1, w2) for h1, w1, h2, w2 in RESIZES])
def test_resize_tile_plan_is_the_kernels_on_card(cuda, n_in, n_out):
    """``tile_plan`` (held on the CPU) is the plan the built kernel
    launches with."""
    taps = K2.band(n_out, n_in)[1].shape[1]
    assert K2.kernel_tile_plan(n_out, n_in, taps) == K2.tile_plan(
        n_out, n_in, taps)


def test_apply_quality_routes_through_the_standalone_k3_and_k1_plainly():
    """On a CPU tensor the image-quality roundtrip is K3's plain version
    then K1's, rounded and clamped to u8; quality "best" is the identity."""
    frames = torch.from_numpy(generate_segment("jackson", 0, IngestSpec())[0])
    sym = dct8_quantize_ref(frames.float(), 6.0)
    want = torch.clamp(torch.round(dct8_dequantize_ref(sym, 6.0)), 0, 255)
    assert torch.equal(T.apply_quality(frames, 6.0), want.to(torch.uint8))
    assert torch.equal(T.apply_quality(frames, 1.0), frames)
    with pytest.raises(ValueError, match="no dct8 path"):
        dct_ops.dct_quantize(frames.float().to("meta"), 6.0)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [IngestSpec(), IngestSpec(720, 1280, 30, 4)])
@pytest.mark.parametrize("qs", [2.0, 6.0, 16.0])
def test_quality_roundtrip_on_card_matches_plain(cuda, spec, qs):
    """``dct_quantize`` then ``dct_dequantize`` on the card (the standalone
    K3, then K1: one launch each) against the plain ``apply_quality`` on
    the CPU: u8 within one grey level, at most 1e-3 of the pixels apart
    (K3 may move 1e-6 of its symbols by one, K1 holds 1e-3)."""
    frames = torch.from_numpy(generate_segment("dashcam", 1, spec)[0])
    LAUNCHES.reset()
    x = frames.to(cuda)
    r = dct_ops.dct_dequantize(dct_ops.dct_quantize(x.float(), qs), qs)
    got = torch.clamp(torch.round(r), 0, 255).to(torch.uint8)
    assert LAUNCHES.snapshot() == {"dct8_quantize": 1, "dct8_dequantize": 1}
    assert torch.equal(T.apply_quality(x, qs), got)
    d = (got.cpu().int() - T.apply_quality(frames, qs).int()).abs()
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel()


@pytest.mark.cuda
def test_codec_on_card_equals_plain_path(cuda):
    """A segment encoded on the card through K3's encoder form gives the
    CPU plain path's blob, and decodes on the card (K1) to the plain
    decode, while the launch counters record the kernels: one encoder
    launch, no standalone K3, one K1 launch (the decoder's)."""
    rng = np.random.default_rng(3)
    f = (120 + rng.normal(0, 20, (13, 48, 64))).clip(0, 255).astype(np.uint8)
    LAUNCHES.reset()
    kw = dict(quant_scale=2.0, keyframe_interval=5, zstd_level=3)
    blob = S.encode_segment(torch.from_numpy(f).to(cuda), **kw)
    assert blob == S.encode_segment(torch.from_numpy(f), **kw)
    want = np.array([0, 6, 7, 12])
    got = S.decode_segment(blob, want, device=cuda)
    assert got.is_cuda
    assert torch.equal(got.cpu(), S.decode_segment(blob, want, device="cpu"))
    n = LAUNCHES.snapshot()
    assert n["dct8_encode_chunks"] == 1
    assert n.get("dct8_quantize", 0) == 0 and n["dct8_dequantize"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_operator_on_card_equals_plain_path(cuda, op):
    """Each operator's items from frames on the card (K2 in NN's pyramid
    and OCR's plate patch, the hits quantised onto the item grid on the
    card) equal the plain path's on the same u8 frames, and are not empty;
    NN launches K2 once for each pyramid level it resizes to."""
    spec = IngestSpec()
    frames = torch.from_numpy(generate_segment("jackson", 1, spec)[0])
    LAUNCHES.reset()
    got = OPERATORS[op].detect(frames.to(cuda), FidelityOption(), spec)
    k2 = LAUNCHES.snapshot().get("resize_bilinear", 0)
    assert got and got == OPERATORS[op].detect(frames, FidelityOption(), spec)
    if op == "nn":
        assert k2 == 2  # scales 2/3 and 1/2; scale 1 is the frames' grid


@pytest.mark.cuda
def test_operators_divide_exactly_on_card(cuda):
    _check_exact_division(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("s", [0, 1, 300, 2049])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("a_kind", ["init", "drawn"])
def test_mamba_scan_kernel_matches_plain_on_card(cuda, n, s, dtype,
                                                 with_h0, a_kind):
    """K5 against its plain version on the same card inputs: y and the
    final state within ``SCAN_TOL`` of their largest value (the two sum
    the C-contraction in different orders and round the decay apart),
    while the plain version on each input-level mutant that changes
    something (``SCAN_MUTANTS``) fails that hold.  A width of 200 channels
    is no multiple of the kernel's block, S 2,049 crosses many chunks and
    ends ragged, and S 0 gives the initial state back."""
    args = _scan_inputs(3, s, 200, n, dtype, seed=s + n, with_h0=with_h0,
                        device=cuda, a_kind=a_kind)
    LAUNCHES.reset()
    got = K5.mamba_scan(*args)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"mamba_scan": 1}
    assert _scan_holds(got, mamba_scan_ref(*args))
    for mutant in SCAN_MUTANTS:
        bad = mutant_inputs(mutant, *args)
        assert bad is None or not _scan_holds(got, mamba_scan_ref(*bad)), \
            mutant


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_geometry_on_card(cuda, n, dtype):
    """The loaded build splits a channel over ``LANES`` lanes, spills
    nothing, and holds every block of Falcon-Mamba-7B's prefill shape
    (batch 4, inner 8192) at once."""
    geo = K5.geometry(n, dtype, 4, 8192)
    assert geo["lanes"] == K5.LANES and geo["local_bytes"] == 0, geo
    assert geo["waves"] == 1, geo


@pytest.mark.cuda
def test_reduced_falcon_mamba_on_card_matches_plain_path(cuda):
    """The reduced Falcon-Mamba's prefill and decode steps on the card
    (K5 once per layer and step) give the CPU plain path's logits within
    1e-4, and the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params

    cfg = get_config("falcon-mamba-7b").reduced()
    model_cpu = init_params(cfg, seed=0, device="cpu")
    model = init_params(cfg, seed=0, device="cpu").to(cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    LAUNCHES.reset()
    toks, _, _ = generate(model, cfg, prompts.to(cuda), 5)
    assert LAUNCHES.snapshot() == {"mamba_scan": cfg.n_layers * 5}
    want, _, _ = generate(model_cpu, cfg, prompts, 5)
    assert toks.cpu().tolist() == want.tolist()
    from repro_torch.models import prefill
    got = prefill(model, cfg, {"tokens": prompts.to(cuda)}, 12)[0]
    ref = prefill(model_cpu, cfg, {"tokens": prompts}, 12)[0]
    assert float((got.cpu() - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("groups", [1, 4, 12])
@pytest.mark.parametrize("sq", [1, 130, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda, hd, groups, sq,
                                                      dtype):
    """K4 over the sequence itself (q_offset 0, every key valid; Sq 1 runs
    the decode form at position 0) against its plain version, element by
    element within ``ref.HOLD``: 130 and 300 query rows leave ragged
    64-row tiles."""
    q, k, v = _attn_inputs(2, sq, sq, 2 * groups, 2, hd, dtype, seed=sq,
                           device=cuda)
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"flash_attention": 1}
    want = attention_ref(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    assert hold_ratio(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("groups", [1, 4, 12])
@pytest.mark.parametrize("cache_len", [1, 255, 256, 257, 700])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_form_matches_plain_on_card(cuda, hd, groups,
                                                           cache_len, dtype):
    """The decode form (Sq 1 at ``q_offset = len - 1``, ``k_len = len``)
    over a 720-position cache whose tail holds other values: lengths on
    both sides of the kernel's 256-key chunk."""
    q, k, v = _attn_inputs(3, 1, 720, 2 * groups, 2, hd, dtype,
                           seed=cache_len, device=cuda)
    got = K4.flash_attention(q, k, v, cache_len - 1, cache_len)
    want = attention_ref(q, k, v, cache_len - 1, cache_len)
    assert hold_ratio(got, want) <= 1


@pytest.mark.cuda
def test_reduced_starcoder2_on_card_matches_plain_path(cuda):
    """A reduced StarCoder2 at head_dim 64 (GQA, 2 groups): prefill and
    decode steps on the card (K4 once per layer and step) give the CPU
    plain path's logits within 1e-4, and the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, prefill

    cfg = get_config("starcoder2-3b").reduced(d_model=256, n_kv_heads=2)
    model_cpu = init_params(cfg, seed=0, device="cpu")
    model = init_params(cfg, seed=0, device="cpu").to(cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    LAUNCHES.reset()
    toks, _, _ = generate(model, cfg, prompts.to(cuda), 5)
    assert LAUNCHES.snapshot() == {"flash_attention": cfg.n_layers * 5}
    want, _, _ = generate(model_cpu, cfg, prompts, 5)
    assert toks.cpu().tolist() == want.tolist()
    got = prefill(model, cfg, {"tokens": prompts.to(cuda)}, 12)[0]
    ref = prefill(model_cpu, cfg, {"tokens": prompts}, 12)[0]
    assert float((got.cpu() - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 15, 16, 300])
@pytest.mark.parametrize("w", [64, 200, 4096])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_kernel_matches_plain_on_card(cuda, s, w, with_h0):
    """K6 against its plain version on the same card inputs: both round
    each step once (``fmaf`` there, a float64 step rounded to float32
    here), so h agrees within ``LRU_TOL`` of its largest value; lengths
    on both sides of the kernel's 32-step chunk, widths not a multiple of
    its 32-column band."""
    g = torch.Generator(device=cuda).manual_seed(s + w)
    a = torch.sigmoid(torch.randn((2, s, w), generator=g, device=cuda))
    b = torch.randn((2, s, w), generator=g, device=cuda)
    h0 = torch.randn((2, w), generator=g, device=cuda) if with_h0 else None
    LAUNCHES.reset()
    got = K6.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"rglru_scan": 1}
    want = rglru_scan_ref(a, b, h0)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= LRU_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 15, 16, 77, 300])
@pytest.mark.parametrize("w", [64, 200, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_gated_scan_kernel_matches_plain_on_card(cuda, s, w, dtype,
                                                       with_h0):
    """K6's gated form in one launch against its plain version within
    ``LRU_TOL`` of the largest |h|, and equal element for element to the
    stepped route on the same card (PyTorch's ops forming a and b, then
    K6): lengths of one step, within and at the end of a 32-step chunk,
    ending mid-chunk inside the ring (77) and past it (300); widths not a
    multiple of the 32-column band."""
    r, i, xc, a_param, h0 = (None if t is None else t.to(cuda) for t in
                             _gates(2, s, w, dtype, seed=s + w,
                                    with_h0=with_h0))
    LAUNCHES.reset()
    got = K6.rglru_gated_scan(r, i, xc, a_param, h0)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"rglru_gated_scan": 1}
    assert got.dtype == torch.float32 and got.shape == (2, s, w)
    assert _lru_hold(got, rglru_gated_scan_ref(r, i, xc, a_param, h0)) <= 1
    stepped = K6.rglru_scan(*gated_ab(r, i, xc, a_param), h0)
    assert int((got != stepped).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("w,offset", [(13, 0), (70, 0), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernels_take_ragged_widths_and_unaligned_tensors_on_card(
        cuda, w, offset, dtype):
    """Widths that are not a multiple of 8 columns, and inputs one element
    past a 16-byte boundary, take the kernels' scalar loads: both forms
    still hold against their plain versions, and the gated form equals
    the stepped route."""
    r, i, xc, a_param, h0 = _gates(2, 45, w, dtype, seed=w, with_h0=True)

    def shifted(t):  # contiguous, ``offset`` elements into its storage
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)
        buf[offset:] = t.reshape(-1).to(cuda)
        return buf[offset:].view(t.shape)

    r, i, xc = (shifted(t) for t in (r, i, xc))
    a_param, h0 = a_param.to(cuda), h0.to(cuda)
    got = K6.rglru_gated_scan(r, i, xc, a_param, h0)
    assert _lru_hold(got, rglru_gated_scan_ref(r, i, xc, a_param, h0)) <= 1
    a, b = (shifted(t) for t in gated_ab(r, i, xc, a_param))
    got_ab = K6.rglru_scan(a, b, h0)
    assert _lru_hold(got_ab, rglru_scan_ref(a, b, h0)) <= 1
    assert int((got != got_ab).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,kvh", [(64, 4, 2), (256, 16, 1)])
@pytest.mark.parametrize("sq,window", [(130, 16), (300, 64), (300, 100),
                                       (700, 256), (300, 400)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_matches_plain_on_card(cuda, hd, h, kvh, sq,
                                                      window, dtype):
    """K4's prefill form with a window against its plain version, element
    by element within ``ref.HOLD``: windows inside one 64-key tile, across
    tiles, not a multiple of 64, and wider than the sequence; head_dim 256
    at RecurrentGemma's 16 query heads over 1 KV head."""
    q, k, v = _attn_inputs(2, sq, sq, h, kvh, hd, dtype, seed=sq + window,
                           device=cuda)
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"flash_attention": 1}
    want = attention_ref(q, k, v, window=window)
    assert hold_ratio(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cache_len", [1, 255, 256, 700])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd256_decode_form_matches_plain_on_card(
        cuda, cache_len, dtype):
    """K4's decode form at head_dim 256 with 16 query heads over 1 KV head
    (RecurrentGemma's ring), within ``ref.HOLD``; its causal prefill form
    at head_dim 256 too."""
    q, k, v = _attn_inputs(2, 1, 700, 16, 1, 256, dtype, seed=cache_len,
                           device=cuda)
    got = K4.flash_attention(q, k, v, cache_len - 1, cache_len)
    assert hold_ratio(got, attention_ref(q, k, v, cache_len - 1,
                                         cache_len)) <= 1
    q, k, v = _attn_inputs(1, 130, 130, 16, 1, 256, dtype, seed=1,
                           device=cuda)
    assert hold_ratio(K4.flash_attention(q, k, v),
                      attention_ref(q, k, v)) <= 1


@pytest.mark.cuda
def test_reduced_recurrentgemma_on_card_matches_plain_path(cuda):
    """A reduced RecurrentGemma at head_dim 64 (d 256, window 32): prefill
    past the window and decode steps that wrap the ring on the card (K6's
    gated form once per RG-LRU layer, K4 once per attention layer, per
    prefill and per step) give the CPU plain path's logits within 1e-4,
    and the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, prefill

    cfg = get_config("recurrentgemma-9b").reduced(n_layers=4, d_model=256)
    model_cpu = init_params(cfg, seed=0, device="cpu")
    model = init_params(cfg, seed=0, device="cpu").to(cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))
    LAUNCHES.reset()
    toks, _, _ = generate(model, cfg, prompts.to(cuda), 5)
    assert LAUNCHES.snapshot() == {"rglru_gated_scan": 3 * 5,
                                   "flash_attention": 1 * 5}
    want, _, _ = generate(model_cpu, cfg, prompts, 5)
    assert toks.cpu().tolist() == want.tolist()
    got = prefill(model, cfg, {"tokens": prompts.to(cuda)}, 45)[0]
    ref = prefill(model_cpu, cfg, {"tokens": prompts}, 45)[0]
    assert float((got.cpu() - ref).abs().max()) <= 1e-4


def _encoder_inputs(bsz, s, h, kvh, dtype, seed, device):
    """q, k, v as ``_attn_inputs`` makes them, with every value of the
    keys in the last 64-key tile (from ``lo``) raised by 4, so that each
    query row takes a share of its output from that tile: a kernel that
    never read the tail, or a plain version with it zeroed, lies far off
    the hold, whatever the seed.  Returns (q, k, v, lo)."""
    q, k, v = _attn_inputs(bsz, s, s, h, kvh, 80, torch.float32, seed)
    lo = (s - 1) // 64 * 64
    v[:, lo:] += 4.0
    return [t.to(dtype).to(device) for t in (q, k, v)] + [lo]


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [63, 64, 65, 1499])
@pytest.mark.parametrize("h,kvh", [(16, 16), (16, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_noncausal_hd80_matches_plain_on_card(cuda, sk, h,
                                                              kvh, dtype):
    """K4's non-causal prefill form at head_dim 80 (HuBERT-XLarge's 16
    heads, and a GQA copy) against its plain version, element by element
    within ``ref.HOLD``: one partial tile (63), one whole (64), a tile and
    one key (65: key 64 alone in a tile of 63 zeroed rows, which every
    query could see without the ``key < Sk`` mask) and HuBERT's 30-s clip
    (1499 frames: 27 keys in the last tile).  The same hold fails for the
    causal plain version (row 0 sees key 0 alone) and for the plain version
    with the last tile's keys zeroed (``_encoder_inputs`` puts a share of
    every row's output in that tile), so the kernel's agreement shows its
    mask acted and its tail was read."""
    q, k, v, lo = _encoder_inputs(2, sk, h, kvh, dtype, seed=sk + kvh,
                                  device=cuda)
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {K4.NONCAUSAL: 1}
    want = attention_ref(q, k, v, causal=False)
    assert got.dtype == dtype and got.shape == want.shape
    assert hold_ratio(got, want) <= 1
    assert hold_ratio(attention_ref(q, k, v), want) > 1
    k0, v0 = k.clone(), v.clone()
    k0[:, lo:] = 0
    v0[:, lo:] = 0
    assert hold_ratio(attention_ref(q, k0, v0, causal=False), want) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_causal_hd80_matches_plain_on_card(cuda, dtype):
    """Head_dim 80 under the causal mask too, over ragged tiles: in f32 its
    column layout (a float4 and a single column a lane in p·v), in bf16 the
    tensor-core kernel's 5 k-steps and 10 n-tiles."""
    q, k, v = _attn_inputs(2, 130, 130, 4, 2, 80, dtype, seed=80,
                           device=cuda)
    assert hold_ratio(K4.flash_attention(q, k, v),
                      attention_ref(q, k, v)) <= 1


@pytest.mark.cuda
def test_flash_attention_c_entry_refuses_noncausal_forms_no_path_takes(cuda):
    """The C entry itself returns cudaErrorInvalidValue (1) and launches
    nothing for a non-causal call at Sq 1, with a window or at an offset,
    and for head_dim 80 in the decode form; the wrapper refuses the same
    before it calls it."""
    fn = K4._kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    q, k, v = _attn_inputs(1, 8, 8, 2, 2, 80, device=cuda)
    out = torch.zeros_like(q)

    def call(sq, q_offset, k_len, window, causal):
        # one split of 8 keys: a plan that covers the decode form's keys
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  1, sq, 8, 2, 2, 80, q_offset, k_len, window, causal,
                  80 ** -0.5, 0.0, 0, 0, None, 1, 8, stream)

    assert call(1, 7, 8, 0, 0) == 1
    assert call(8, 0, 8, 4, 0) == 1
    assert call(8, 1, 8, 0, 0) == 1
    assert call(8, 0, 7, 0, 0) == 1
    assert call(1, 7, 8, 0, 1) == 1  # hd 80 has no decode form
    torch.cuda.synchronize()
    assert not out.any()
    assert call(8, 0, 8, 0, 0) == 0
    torch.cuda.synchronize()
    assert hold_ratio(out, attention_ref(q, k, v, causal=False)) <= 1


@pytest.mark.cuda
def test_reduced_hubert_on_card_matches_plain_path(cuda):
    """A reduced HuBERT at head_dim 80 (d 160, 2 heads): the encoder's
    forward on the card (K4 once per layer, non-causal) gives the CPU plain
    path's logits within 1e-4 of their largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params

    cfg = get_config("hubert-xlarge").reduced(n_layers=3, d_model=160,
                                              n_heads=2)
    model_cpu = init_params(cfg, seed=0, device="cpu")
    model = init_params(cfg, seed=0, device="cpu").to(cuda)
    x = torch.randn((2, 99, 160), generator=torch.Generator().manual_seed(2))
    LAUNCHES.reset()
    got = forward(model, cfg, {"embeds": x.to(cuda)})
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {K4.NONCAUSAL: cfg.n_layers}
    ref = forward(model_cpu, cfg, {"embeds": x})
    assert float((got.cpu() - ref).abs().max()) <= \
        1e-4 * float(ref.abs().max())


def _capped_inputs(bsz, sq, sk, h, kvh, hd, dtype, seed, device, q_offset=0):
    """q, k, v as ``_attn_inputs`` makes them, the keys 30 times larger (so
    scores spread far past a cap of 50) and key row ``q_offset + i`` a
    multiple of query row i (``scores_over_cap``: a score of 100 in every
    query row, by construction at every Sq, Sq 1 included), rounded to
    ``dtype`` last."""
    q, k, v = _attn_inputs(bsz, sq, sk, h, kvh, hd, torch.float32, seed)
    k = scores_over_cap(q, 30 * k, 50.0, q_offset)
    return [t.to(dtype).to(device) for t in (q, k, v)]


def _max_score(q, k):
    kk = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return float(torch.einsum("bqhd,bkhd->bhqk",
                              q.float() * q.shape[3] ** -0.5, kk).max())


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,kvh", [(256, 8, 4), (64, 4, 2), (32, 4, 1)])
@pytest.mark.parametrize("sq", [1, 130, 300])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_capped_matches_plain_on_card(cuda, hd, h, kvh, sq,
                                                      window, dtype):
    """K4 with gemma2's logit soft-cap (50), over a prompt (Sq 130, 300:
    ragged tiles) and in the decode form (Sq 1 over a 700-position cache
    at length 300), with and without a window, against its plain version
    element by element within ``ref.HOLD``: gemma2's 8 heads over 4 at
    head_dim 256, GQA at 64 and the launcher's head_dim 32.  Every query
    row has a score of 100 by construction; the plain version without the
    cap, and without the window where there is one, fails the hold; the
    launch counts under its form's key."""
    sk, q_offset = (700, 299) if sq == 1 else (sq, 0)
    q, k, v = _capped_inputs(2, sq, sk, h, kvh, hd, dtype, seed=sq + window,
                             device=cuda, q_offset=q_offset)
    k_len = q_offset + 1 if sq == 1 else sk
    assert _max_score(q, k[:, q_offset:q_offset + sq]) > 50.0
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, q_offset, k_len, window,
                             logit_cap=50.0)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {K4.launch_key(True, window, 50.0): 1}
    want = attention_ref(q, k, v, q_offset, k_len, window, logit_cap=50.0)
    assert got.dtype == dtype and hold_ratio(got, want) <= 1
    assert hold_ratio(attention_ref(q, k, v, q_offset, k_len, window),
                      want) > 1
    if window:
        assert hold_ratio(attention_ref(q, k, v, q_offset, k_len,
                                        logit_cap=50.0), want) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,kvh", [(32, 4, 1), (64, 4, 2), (80, 16, 16),
                                      (128, 24, 2), (256, 16, 1)])
@pytest.mark.parametrize("sq", [17, 130, 300, 1499])
@pytest.mark.parametrize("form", sorted(PREFILL_FORMS))
def test_flash_attention_bf16_prefill_forms_on_card(cuda, hd, h, kvh, sq,
                                                     form):
    """K4's bf16 prefill form, the tensor-core kernel, against its plain
    version element by element within ``ref.HOLD`` at every head dim it
    takes (up to 16 query heads a KV head), in every form (causal, a window
    narrower than a key tile and one across tiles, non-causal, capped with
    and without a window), at 17 rows (below one 64-row tile) and at 130,
    300 and 1499 (ragged 16- and 64-row tiles and key tiles); one count
    under its form's key.  The plain version with one middle 64-key tile
    of v zeroed fails the same hold."""
    q, k, v, kw = _prefill_inputs(form, 2, sq, h, kvh, hd, torch.bfloat16,
                                   seed=hd + sq + len(form), device=cuda)
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {K4.launch_key(kw["causal"], kw["window"],
                                                 kw["logit_cap"]): 1}
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert hold_ratio(got, want) <= 1
    lo = sq // 2 // 64 * 64
    v_bad = v.clone()
    v_bad[:, lo:lo + 64] = 0
    assert hold_ratio(attention_ref(q, k, v_bad, **kw), want) > 1


def _kernel_names(fn, calls=3):
    """The names of the kernels ``calls`` calls of ``fn()`` ran on the
    card, by the profiler.  Several calls, since a trace may miss its
    window's first kernel (one call's trace once came back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(PREFILL_FORMS))
def test_flash_attention_f32_prefill_keeps_the_f32_hold_on_card(cuda, form):
    """An f32 prefill call still runs the f32 CUDA-core kernel and meets
    the f32 hold (2^-13 of the row's rms), which bf16 tensor cores could
    not; a bf16 call of the same form runs the tensor-core kernel alone
    (StarCoder2's 24 heads over 2 of 128, 300 rows)."""
    q, k, v, kw = _prefill_inputs(form, 2, 300, 24, 2, 128, torch.float32,
                                   seed=len(form), device=cuda)
    got = K4.flash_attention(q, k, v, **kw)
    assert got.dtype == torch.float32
    assert hold_ratio(got, attention_ref(q, k, v, **kw)) <= 1
    names = _kernel_names(lambda: K4.flash_attention(q, k, v, **kw))
    assert any("prefill_kernel<float" in n for n in names), names
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    names = _kernel_names(lambda: K4.flash_attention(qb, kb, vb, **kw))
    assert len(names) == 1 and "prefill_mma_kernel<128" in names.pop()


@pytest.mark.cuda
@pytest.mark.parametrize("cache_len", [1, 255, 256, 257, 700])
@pytest.mark.parametrize("window", [1, 64, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_window_matches_plain_on_card(cuda, cache_len,
                                                             window, dtype):
    """K4's decode form with a window over a linear cache (gemma2's local
    layers at head_dim 256, 8 heads over 4): the token at ``len - 1``
    sees keys ``len - window`` .. ``len - 1`` of a 700-position cache,
    windows inside, on and across the kernel's 256-key chunks; the plain
    version without the window fails the hold wherever it masks."""
    q, k, v = _attn_inputs(2, 1, 700, 8, 4, 256, dtype, seed=cache_len,
                           device=cuda)
    k = 4 * k  # scores spread, so the masked keys carry weight
    got = K4.flash_attention(q, k, v, cache_len - 1, cache_len, window)
    want = attention_ref(q, k, v, cache_len - 1, cache_len, window)
    assert hold_ratio(got, want) <= 1
    if cache_len > window:
        assert hold_ratio(attention_ref(q, k, v, cache_len - 1, cache_len),
                          want) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,kvh", [(32, 4, 2), (64, 4, 2), (128, 24, 2),
                                      (256, 8, 4), (256, 16, 1)])
@pytest.mark.parametrize("cache_len", [1, 257, 700])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (100, 50.0)])
def test_flash_attention_f32_query_over_bf16_cache_on_card(cuda, hd, h, kvh,
                                                           cache_len, window,
                                                           cap):
    """The decode form with a float32 query over a bfloat16 cache (float32
    weights over the reference's default cache), plain and capped with a
    window, at every decode head dim: float32 out, held by ``ref.HOLD``'s
    float32 row (the bfloat16 inputs are exact in float32).  The plain
    version with q rounded to bfloat16 first fails that hold wherever more
    than one key is seen, so the kernel reads q in float32."""
    if cap:
        q, k, v = _capped_inputs(2, 1, 700, h, kvh, hd, torch.float32,
                                 seed=cache_len + hd, device=cuda,
                                 q_offset=cache_len - 1)
    else:  # scores spread (4 sigma), no key set to dominate
        q, k, v = _attn_inputs(2, 1, 700, h, kvh, hd, seed=cache_len + hd,
                               device=cuda)
        k = 4 * k
    k, v = k.bfloat16(), v.bfloat16()
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, cache_len - 1, cache_len, window,
                             logit_cap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {K4.launch_key(True, window, cap): 1}
    want = attention_ref(q, k, v, cache_len - 1, cache_len, window,
                         logit_cap=cap)
    assert got.dtype == want.dtype == torch.float32
    assert hold_ratio(got, want) <= 1
    if cache_len > 1:
        rounded = attention_ref(q.bfloat16(), k, v, cache_len - 1, cache_len,
                                window, logit_cap=cap).float()
        assert hold_ratio(rounded, want) > 1


@pytest.mark.cuda
def test_flash_attention_c_entry_refuses_mixed_and_misplaced_forms(cuda):
    """The C entry returns cudaErrorInvalidValue (1) and launches nothing
    for mixed dtypes in the prefill form, a bfloat16 query over a float32
    cache, a decode window with the query anywhere but at the cache's last
    valid position, and a negative cap; it takes an f32 query over a
    bf16 cache in the decode form, capped and windowed."""
    fn = K4._kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    q, k, v = _attn_inputs(1, 8, 8, 2, 2, 32, device=cuda)
    kb, vb = k.bfloat16(), v.bfloat16()
    out = torch.zeros_like(q)

    def call(sq, q_offset, k_len, window, cap, q_bf16, kv_bf16):
        # one split of 8 keys: a plan that covers the decode form's keys
        kk, vv = (kb, vb) if kv_bf16 else (k, v)
        return fn(q.data_ptr(), kk.data_ptr(), vv.data_ptr(), out.data_ptr(),
                  1, sq, 8, 2, 2, 32, q_offset, k_len, window, 1,
                  32 ** -0.5, cap, q_bf16, kv_bf16, None, 1, 8, stream)

    assert call(8, 0, 8, 0, 0.0, 0, 1) == 1
    assert call(1, 7, 8, 0, 0.0, 1, 0) == 1
    assert call(1, 6, 8, 4, 0.0, 0, 0) == 1
    assert call(8, 0, 8, 0, -1.0, 0, 0) == 1
    torch.cuda.synchronize()
    assert not out.any()
    assert call(1, 7, 8, 4, 50.0, 0, 1) == 0
    torch.cuda.synchronize()
    want = attention_ref(q[:, :1], kb, vb, 7, 8, 4, logit_cap=50.0)
    assert hold_ratio(out[:, :1], want) <= 1


@pytest.mark.cuda
def test_reduced_gemma2_on_card_matches_plain_path(cuda):
    """A reduced Gemma2 at its own head_dim 256 (d 128, 4 heads over 2,
    window 16, caps 50 and 30, post-norms) with float32 weights served
    over the launcher's bfloat16 cache: a 40-token prompt past the window
    and 7 decode steps on the card (capped K4 once per layer and step, the
    even layers windowed) give the CPU plain path's logits within 1e-4 of
    their largest magnitude, and the same greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, prefill

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(
        n_layers=4, d_model=128), head_dim=256)
    model_cpu = init_params(cfg, seed=0, device="cpu")
    model = init_params(cfg, seed=0, device="cpu").to(cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))
    LAUNCHES.reset()
    toks, _, _ = generate(model, cfg, prompts.to(cuda), 8)
    assert LAUNCHES.snapshot() == {K4.CAPPED: 2 * 8,
                                   K4.CAPPED_WINDOWED: 2 * 8}
    want, _, _ = generate(model_cpu, cfg, prompts, 8)
    assert toks.cpu().tolist() == want.tolist()
    got = prefill(model, cfg, {"tokens": prompts.to(cuda)}, 48,
                  torch.bfloat16)[0]
    ref = prefill(model_cpu, cfg, {"tokens": prompts}, 48, torch.bfloat16)[0]
    assert float((got.cpu() - ref).abs().max()) <= \
        1e-4 * float(ref.abs().max())


#: the decode form's (q, k/v) dtype pairs
DECODE_PAIRS = [(torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.float32),
                (torch.float32, torch.bfloat16)]


def _card_splits(bsz, sk, kvh, window=0):
    """The split plan K4's wrapper launches on this card."""
    return K4.decode_splits(bsz, sk, kvh, window,
                            K4.sm_count(torch.cuda.current_device()))


def _assert_split_mutants_fail(q, k, v, q_offset, k_len, window, cap, want):
    """Where the keys seen span two splits or more of K4's plan on this
    card, the plain version with the middle live split's values zeroed,
    and the plain version over the keys before the last live split's
    start, each fail ``ref.HOLD`` against ``want``: the hold sees a split
    dropped or cut short."""
    _, live = K4.decode_plan(k, q_offset, k_len, window)
    if len(live) < 2:
        return
    lo, hi = live[(len(live) - 1) // 2]
    v_bad = v.clone()
    v_bad[:, lo:hi] = 0
    assert hold_ratio(attention_ref(q, k, v_bad, q_offset, k_len, window,
                                    logit_cap=cap), want) > 1, "split drop"
    assert hold_ratio(attention_ref(q, k, v, q_offset, live[-1][0], window,
                                    logit_cap=cap), want) > 1, "cut"


def _split_inputs(bsz, sk, h, kvh, hd, pair, seed, length, device, cap=0.0,
                  window=0):
    """q, k, v from a seed on ``device`` with the last key (position
    ``length - 1``) and the first key of the middle live split of K4's
    plan on that card scoring 2·c for the lead query head of each group
    (``scores_over_cap``; c = ``cap``, or 4 with no cap, over keys 30
    times larger when capped), so that each carries a share of every such
    row's output that a dropped split or a cut plan would lose; then q and
    k/v rounded to ``pair``."""
    q, k, v = _attn_inputs(bsz, 1, sk, h, kvh, hd, torch.float32, seed,
                           device)
    c = cap or 4.0
    k = scores_over_cap(q, 30 * k if cap else k, c, length - 1)
    _, live = K4.decode_plan(k, length - 1, length, window)
    if len(live) > 1:
        k = scores_over_cap(q, k, c, live[(len(live) - 1) // 2][0])
    return q.to(pair[0]), k.to(pair[1]), v.to(pair[1])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("groups", [1, 2, 12, 16])
@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=["bf16", "f32", "f32-bf16"])
@pytest.mark.parametrize("where", ["one key", "split - 1", "split",
                                   "split + 1", "last split of one key"])
def test_flash_attention_split_decode_matches_plain_on_card(cuda, hd, groups,
                                                            pair, where):
    """K4's split-KV decode form at lengths taken from its own split plan
    over a (2, 3000, 4 KV heads) cache -- one key, a split less one, one
    split, one key past it, and a last split of one key -- at 1, 2, 12
    and 16 query heads per KV head, every decode head dim and dtype pair,
    against its plain version element by element within ``ref.HOLD``; one
    count in ``build.LAUNCHES``; a dropped or cut split fails the hold."""
    bsz, sk, kvh = 2, 3000, 4
    n_split, split_len = _card_splits(bsz, sk, kvh)
    assert n_split > 1
    length = {"one key": 1, "split - 1": split_len - 1, "split": split_len,
              "split + 1": split_len + 1,
              "last split of one key": (n_split - 1) * split_len + 1}[where]
    q, k, v = _split_inputs(bsz, sk, groups * kvh, kvh, hd, pair,
                            hd + groups + length, length, cuda)
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, length - 1, length)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"flash_attention": 1}
    want = attention_ref(q, k, v, length - 1, length)
    assert got.dtype == pair[0] and hold_ratio(got, want) <= 1
    _assert_split_mutants_fail(q, k, v, length - 1, length, 0, 0.0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 4096])
@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=["bf16", "f32", "f32-bf16"])
def test_flash_attention_gemma2_decode_matches_plain_on_card(cuda, window,
                                                             pair):
    """Gemma2-2B's decode at its full shape: one query of 8 heads over 4 KV
    heads of 256 against an 8,192-position cache at length 8,161, soft-cap
    50 with scores over the cap by construction, with and without the
    local layers' window of 4,096, held element by element within
    ``ref.HOLD``; the plain version without the cap fails it, and so do a
    dropped and a cut split."""
    bsz, sk, h, kvh, hd, length, cap = 2, 8192, 8, 4, 256, 8161, 50.0
    q, k, v = _split_inputs(bsz, sk, h, kvh, hd, pair, 23 + window, length,
                            cuda, cap, window)
    LAUNCHES.reset()
    got = K4.flash_attention(q, k, v, length - 1, length, window,
                             logit_cap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {K4.launch_key(True, window, cap): 1}
    want = attention_ref(q, k, v, length - 1, length, window, logit_cap=cap)
    assert got.dtype == pair[0] and hold_ratio(got, want) <= 1
    assert hold_ratio(attention_ref(q, k, v, length - 1, length, window),
                      want) > 1
    _assert_split_mutants_fail(q, k, v, length - 1, length, window, cap, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one key of 8192", "window past the keys",
                                  "window from inside a cache split"])
@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=["bf16", "f32", "f32-bf16"])
def test_flash_attention_decode_with_empty_splits_on_card(cuda, case, pair):
    """Splits left empty, and windows off the cache's own split grid: one
    valid key of an 8,192-position cache (every split but the first holds
    none); a window of 4,096 over 1,000 valid keys (the splits past them
    hold none); and a window whose first key lies inside a split of the
    cache's grid (the splits start from it); within ``ref.HOLD``, the
    plain version without the window failing it, and a dropped or cut
    split too."""
    bsz, sk, h, kvh, hd = 2, 8192, 8, 4, 256
    n_split, split_len = _card_splits(bsz, sk, kvh)
    length, window = {
        "one key of 8192": (1, 0),
        "window past the keys": (1000, 4096),
        "window from inside a cache split": (
            sk - split_len // 3,
            sk - split_len // 3 - (n_split // 2 * split_len + split_len // 2)),
    }[case]
    q, k, v = _split_inputs(bsz, sk, h, kvh, hd, pair, 5 + length, length,
                            cuda, window=window)
    got = K4.flash_attention(q, k, v, length - 1, length, window)
    want = attention_ref(q, k, v, length - 1, length, window)
    assert got.dtype == pair[0] and hold_ratio(got, want) <= 1
    if length > window > 0:
        assert hold_ratio(attention_ref(q, k, v, length - 1, length),
                          want) > 1
    _assert_split_mutants_fail(q, k, v, length - 1, length, window, 0.0,
                               want)


@pytest.mark.cuda
def test_flash_attention_c_entry_refuses_split_plans_that_miss_keys(cuda):
    """The C entry returns cudaErrorInvalidValue (1) and launches nothing
    for a decode split plan that does not cover the valid keys, has no
    split or no key a split, or has several splits and no workspace; with
    two splits of 4 keys over a workspace it takes the call."""
    fn = K4._kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    q, k, v = _attn_inputs(1, 1, 8, 4, 2, 64, device=cuda)
    ws = torch.empty(1 * 2 * 2 * 2 * (64 + 2), device=cuda)
    out = torch.zeros_like(q)

    def call(ws_ptr, n_split, split_len):
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  1, 1, 8, 4, 2, 64, 7, 8, 0, 1, 64 ** -0.5, 0.0, 0, 0,
                  ws_ptr, n_split, split_len, stream)

    assert call(ws.data_ptr(), 1, 7) == 1   # key 7 in no split
    assert call(ws.data_ptr(), 2, 3) == 1   # keys 6, 7 in none
    assert call(ws.data_ptr(), 0, 8) == 1
    assert call(ws.data_ptr(), 1, 0) == 1
    assert call(None, 2, 4) == 1
    torch.cuda.synchronize()
    assert not out.any()
    assert call(ws.data_ptr(), 2, 4) == 0
    torch.cuda.synchronize()
    assert hold_ratio(out, attention_ref(q, k, v, 7, 8)) <= 1
