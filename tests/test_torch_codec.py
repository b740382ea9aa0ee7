"""Port codec vs the JAX reference: block transforms, encoder symbols within
a stated bound, blobs decodable both ways, the decode sweep of
``test_decode_path.py`` on reference-written blobs, and the resize against
``jax.image.resize``.  Runs the port's plain (CPU) path; the CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_kernels.py`` (marked ``cuda``) and by ``chip_smoke.py``.

Bounds, stated up front:
* intra symbols (``frames_to_symbols``) are equal;
* residuals (``symbols_to_residuals``) agree to 1e-3, the reference's own
  Pallas-vs-jnp bound;
* at most 0.5% of a blob's symbols may differ, each by at most 2: float
  differences in the DPCM reconstruction would carry into later residuals;
* decoded uint8 frames differ by at most 1.
The port sums each 8-term dot in XLA:CPU's order (``transform._dot8``), and
on the reference's host the tests print 0 differing symbols and pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.codec import segment as RS
from repro.codec import transform as RT

from repro_torch.codec import segment as S
from repro_torch.codec import transform as T
from repro_torch.kernels.dct8.ref import dct8_dequantize_ref, dct8_quantize_ref


def _frames(n=16, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None, None]
    y = np.arange(h)[None, :, None]
    x = np.arange(w)[None, None, :]
    f = 120 + 50 * np.sin((x + 2 * t) / 9) + 30 * np.cos((y - t) / 7)
    return (f + rng.normal(0, 3, (n, h, w))).clip(0, 255).astype(np.uint8)


def _ref_encode(f, *, kint=5, version=None, qs=2.0, lvl=3):
    return RS.encode_segment(f, quant_scale=qs, keyframe_interval=kint,
                             zstd_level=lvl, version=version)


def _encode(f, *, kint=5, version=None, qs=2.0, lvl=3):
    return S.encode_segment(torch.from_numpy(f), quant_scale=qs,
                            keyframe_interval=kint, zstd_level=lvl,
                            version=version)


def _symbols(blob):
    header, payload = RS._parse(blob)
    n, k = header["n"], header["k"]
    sym, _ = RS._chunk_symbols(header, payload, np.unique(np.arange(n) // k),
                               -(-n // k))
    return np.concatenate([sym[c, :min(k, n - c * k)]
                           for c in range(len(sym))])


# ---------------------------------------------------------------------------
# block transforms
# ---------------------------------------------------------------------------

def _residual_input(kind, seed):
    if kind == "normal":
        rng = np.random.default_rng(seed)
        return rng.normal(0, 40, (6, 48, 64)).astype(np.float32)
    # integer pixels minus mid-grey, the encoder's intra input: many
    # coefficients land exactly on a rounding tie, so the summation order
    # of each 8-term dot decides the symbol
    from repro.analytics.scene import generate_segment
    return generate_segment("jackson", seed)[0][:8].astype(np.float32) - 128


@pytest.mark.parametrize("kind", ["normal", "scene"])
@pytest.mark.parametrize("qs", [1.0, 2.0, 6.0, 16.0])
def test_frames_to_symbols_equal_reference(qs, kind):
    x = _residual_input(kind, int(qs))
    ref = np.asarray(RT.frames_to_symbols(jnp.asarray(x), qs))
    got = T.frames_to_symbols(torch.from_numpy(x), qs).numpy()
    assert got.dtype == np.int16 and np.array_equal(got, ref)
    assert np.array_equal(dct8_quantize_ref(torch.from_numpy(x), qs).numpy(),
                          ref)
    r_ref = np.asarray(RT.symbols_to_residuals(jnp.asarray(ref), qs))
    r = T.symbols_to_residuals(torch.from_numpy(ref), qs).numpy()
    np.testing.assert_allclose(r, r_ref, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        dct8_dequantize_ref(torch.from_numpy(ref), qs).numpy(), r)


def test_block_layout_helpers_invert():
    x = torch.arange(2 * 16 * 24, dtype=torch.float32).reshape(2, 16, 24)
    b = T.to_blocks(x)
    assert tuple(b.shape) == (2, 2, 3, 8, 8)
    assert torch.equal(b[1, 1, 2], x[1, 8:16, 16:24])
    assert torch.equal(T.from_blocks(b), x)


# ---------------------------------------------------------------------------
# encoder: port blobs vs reference blobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kint,qs,version", [(5, 2.0, 2), (10, 1.0, 2),
                                             (50, 6.0, 1), (3, 16.0, 2)])
def test_port_blobs_match_reference_within_bound(kint, qs, version):
    f = _frames(n=13, seed=kint)
    ref_blob = _ref_encode(f, kint=kint, qs=qs, version=version)
    blob = _encode(f, kint=kint, qs=qs, version=version)
    h_ref, h = RS.segment_info(ref_blob), S.segment_info(blob)
    assert len(h.get("spans", ())) == len(h_ref.get("spans", ()))
    h.pop("spans", None), h_ref.pop("spans", None)
    assert h == h_ref
    a, b = _symbols(blob), _symbols(ref_blob)
    diff = np.abs(a.astype(np.int32) - b)
    n_diff = int((diff > 0).sum())
    print(f"k={kint} qs={qs}: {n_diff} of {a.size} symbols differ, "
          f"max |d|={diff.max()}")
    assert n_diff <= 0.005 * a.size and diff.max() <= 2
    # each side decodes the other's blob, within one grey level
    port_of_ref = S.decode_segment(ref_blob, device="cpu").numpy()
    ref_of_port = np.asarray(RS.decode_segment(blob))
    assert np.abs(port_of_ref.astype(int)
                  - RS.decode_segment(ref_blob)).max() <= 1
    assert np.abs(ref_of_port.astype(int)
                  - S.decode_segment(blob, device="cpu").numpy()).max() <= 1


def test_intra_only_blob_symbols_equal_reference():
    """k=1: every frame is intra-coded from mid-grey, so no reconstruction
    error carries over and the symbols are equal."""
    f = _frames(n=6, seed=3)
    assert np.array_equal(_symbols(_encode(f, kint=1)),
                          _symbols(_ref_encode(f, kint=1)))


def test_raw_blob_is_byte_identical():
    f = _frames(n=5)
    assert S.encode_raw(torch.from_numpy(f)) == RS.encode_raw(f)


# ---------------------------------------------------------------------------
# decode sweep on reference-written blobs (tests/test_decode_path.py)
# ---------------------------------------------------------------------------

def _want_sets(n, seed):
    rng = np.random.default_rng(seed)
    return [None, np.array([0]), np.array([2, 2, 7, 7, 7, 12]),
            np.sort(rng.choice(n, size=5, replace=False)),
            np.empty(0, np.int64), np.arange(n - 3, n)]


@pytest.mark.parametrize("zlib", [False, True])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("kint", [5, 10, 50])
def test_decode_sweep_on_reference_blobs(kint, version, zlib, monkeypatch):
    if zlib:
        monkeypatch.setattr(RS, "zstandard", None)
        monkeypatch.setattr(S, "zstandard", None)
    f = _frames(n=13, seed=kint)
    blob = _ref_encode(f, kint=kint, version=version)
    assert RS.segment_info(blob)["ec"] == ("zlib" if zlib else "zstd")
    n_px = n_diff = 0
    for want in _want_sets(len(f), kint):
        ref, ref_info = RS.decode_segment_ex(blob, want)
        got, info = S.decode_segment_ex(blob, want, device="cpu")
        got = got.numpy()
        assert got.shape == ref.shape and got.dtype == np.uint8
        d = np.abs(got.astype(int) - ref)
        assert d.size == 0 or d.max() <= 1
        n_px, n_diff = n_px + d.size, n_diff + int((d > 0).sum())
        for key in ("bytes", "chunks", "frames"):
            assert info[key] == ref_info[key], key
        # the port's own oracle decoder agrees with its batched decoder
        assert np.array_equal(
            S.decode_segment_scan(blob, want, device="cpu").numpy(), got)
    print(f"k={kint} v{version} zlib={zlib}: {n_diff} of {n_px} pixels "
          f"differ by 1")


def test_decode_many_matches_reference_and_per_blob():
    blobs = [_ref_encode(_frames(seed=s), kint=5) for s in range(3)]
    blobs.append(RS.encode_raw(_frames(seed=9)))
    want = np.array([0, 6, 11])
    outs, cost = S.decode_many(blobs, want, device="cpu")
    ref_outs, ref_cost = RS.decode_many(blobs, want)
    assert cost == ref_cost
    for blob, out, ref in zip(blobs, outs, ref_outs):
        assert np.abs(out.numpy().astype(int) - ref).max() <= 1
        assert torch.equal(out, S.decode_segment(blob, want, device="cpu"))


def test_decode_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = _ref_encode(_frames(n=5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.decode_segment(blob)


# ---------------------------------------------------------------------------
# resize (K2's function) vs jax.image.resize
# ---------------------------------------------------------------------------

# main-path shapes at the default spec (SF -> CF grids, NN's 2/3 and 1/2
# pyramid, OCR's plate patch), an upscale, a one-axis resize, identity
RESIZES = [(96, 160, 72, 120), (96, 160, 64, 106), (72, 120, 56, 88),
           (96, 160, 48, 80), (27, 78, 9, 26), (36, 60, 96, 160),
           (96, 160, 96, 120), (64, 64, 14, 14), (9, 26, 9, 26)]


@pytest.mark.parametrize("h1,w1,h2,w2", RESIZES)
def test_resize_matches_jax_image_resize(h1, w1, h2, w2):
    """Within 1e-3 on 0-255 data.  The port's weights follow what XLA
    compiles ``jax.image.resize``'s weights to, up to where the compiler
    fuses a multiply-add (``test_resize_weights_follow_xla_jit``), and the
    two sum the resize products in different orders."""
    rng = np.random.default_rng(h1 * w2)
    x = (rng.random((3, h1, w1)) * 255).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, h2, w2),
                                      "bilinear"))
    got = T.resize(torch.from_numpy(x), h2, w2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


# (n_in, n_out) of every one-axis resize the operators, the fidelity
# conversions of these tests and chip_smoke.py run: 96x160 CF grids, NN's
# pyramid at 96x160 and 720p, OCR's plate patch, the 720p SF transcodes
# and the 100p rung, and the upscales of RESIZES
WEIGHT_PAIRS = [(96, 72), (160, 120), (96, 64), (160, 106), (72, 56),
                (120, 88), (96, 48), (160, 80), (96, 32), (160, 64),
                (72, 32), (120, 64), (96, 16), (160, 32), (48, 24), (80, 48),
                (27, 9), (78, 26), (68, 9), (208, 26), (64, 14), (36, 96),
                (60, 160), (720, 544), (1280, 960), (544, 96), (960, 176),
                (720, 480), (1280, 853), (720, 360), (1280, 640)]
# pairs whose jitted weights do not depend on whether the compiler fuses
# ``1 - |d|·r`` or the sample position into a multiply-add: equal there
WEIGHTS_EQUAL = {(96, 72), (160, 120), (78, 26), (208, 26), (36, 96),
                 (60, 160), (720, 480), (1280, 960), (720, 360), (1280, 640),
                 (96, 48), (160, 80), (48, 24)}


def _xla_weights(n_in, n_out):
    """The weights the reference's jitted resize applies along one axis,
    read back by resizing an identity: (n_out, n_in) float32."""
    eye = jnp.eye(n_in, dtype=jnp.float32)[None]
    return np.asarray(RT._resize(eye, h=n_out, w=n_in))[0]


@pytest.mark.parametrize("n", [5, 27, 32, 33, 64, 96, 720, 1056, 1280])
def test_resize_weight_sums_take_xla_order(n):
    """``_xla_column_sums`` reproduces ``jnp.sum(w, axis=0)`` under ``jit``
    bit for bit: runs of 32 rows summed in order after an even zero pad,
    repeated while more than 32 partial sums remain."""
    from repro_torch.kernels.resize.resize import _xla_column_sums

    w = np.random.default_rng(n).random((n, 37)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(w))
    assert np.array_equal(_xla_column_sums(w)[0], want)


@pytest.mark.parametrize("n_in,n_out", WEIGHT_PAIRS)
def test_resize_weights_follow_xla_jit(n_in, n_out):
    """``interp_matrix`` against the weights the reference's jitted
    ``jax.image.resize`` applies.  The port reproduces XLA's rewrite of
    the division by the kernel scale into a multiply by its reciprocal and
    the reduction order of the normalising sums; it does not reproduce
    where LLVM fuses a multiply-add in the compiled loops, which changes
    with the host's vector width and the loop's tail.  So the weights are
    equal for the pairs that fusion cannot change and within 2e-5 for the
    rest; the test prints how many differ (ROADMAP §3)."""
    from repro_torch.kernels.resize.resize import interp_matrix

    got, want = interp_matrix(n_out, n_in), _xla_weights(n_in, n_out)
    n_diff = int((got != want).sum())
    print(f"{n_in}->{n_out}: {n_diff} of {got.size} weights differ, max "
          f"{float(np.abs(got - want).max()):.3g}")
    assert float(np.abs(got - want).max()) <= 2e-5
    if (n_in, n_out) in WEIGHTS_EQUAL:
        assert n_diff == 0


def _weights_fused(n_out, n_in, fuse_sample, fuse_tri):
    """``interp_matrix``'s arithmetic with either of its two multiply-adds
    fused (one rounding, emulated in float64 where the product is exact):
    the sample position ``(o + 0.5)·scale - 0.5`` and the triangle
    ``1 - |d|·r``."""
    from repro_torch.kernels.resize.resize import _xla_column_sums

    def fma(a, b, c):
        return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
                + np.asarray(c, np.float64)).astype(np.float32)

    inv_scale = np.float32(1.0 / (n_out / n_in))
    r = np.float32(1) / np.float32(max(float(inv_scale), 1.0))
    o = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    sample = fma(o, inv_scale, np.float32(-0.5)) if fuse_sample else \
        (o * inv_scale).astype(np.float32) - np.float32(0.5)
    d = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = fma(-d, r, np.float32(1)) if fuse_tri else \
        np.float32(1) - (d * r).astype(np.float32)
    w = np.maximum(np.float32(0), w)
    total = _xla_column_sums(w)
    ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
    w = np.where(ok, w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w,
                 np.float32(0))
    return np.ascontiguousarray(w.T.astype(np.float32))


def test_resize_weight_fusions_are_mixed_within_a_pair():
    """The weights the reference's jitted resize applies, read back with
    one-hot probes (``_xla_weights``) for every pair of ``WEIGHT_PAIRS``,
    against the port's arithmetic with each of its two multiply-adds
    fused or not (four rules).  Prints, per pair, how many weights each
    rule misses, and for the pairs no rule reproduces, which rule matches
    each output (u: unfused only, f: the triangle fused only, b: both,
    n: neither).  Where LLVM contracts a multiply-add into an FMA varies
    from output to output within one compiled loop, so no rule of the
    port's reproduces the reference's weights everywhere; the fault is the
    reference's dependence on its compiler and host (ROADMAP §3).  Only
    the bound every rule keeps is asserted."""
    rules = [(0, 0), (0, 1), (1, 0), (1, 1)]
    unmatched = []
    for n_in, n_out in WEIGHT_PAIRS:
        want = _xla_weights(n_in, n_out)
        got = {rule: _weights_fused(n_out, n_in, *rule) for rule in rules}
        misses = {rule: int((w != want).sum()) for rule, w in got.items()}
        print(f"{n_in}->{n_out} ({want.size} weights): misses by rule "
              f"(fuse sample, fuse triangle) {misses}")
        for w in got.values():
            assert float(np.abs(w - want).max()) <= 2e-5
        if min(misses.values()):
            unmatched.append((n_in, n_out))
            u = (got[0, 0] == want).all(axis=1)
            f = (got[0, 1] == want).all(axis=1)
            print("  per output: " + "".join(
                "b" if a and b else "u" if a else "f" if b else "n"
                for a, b in zip(u, f)))
    print(f"{len(unmatched)} of {len(WEIGHT_PAIRS)} pairs match no rule: "
          f"{unmatched}")


@pytest.mark.parametrize("stream", ["jackson", "dashcam"])
def test_fidelity_conversion_within_one_grey_level(stream):
    """``convert_fidelity`` (sampling, crop, K2's resize, round to u8)
    against the reference's on scene frames: u8 values differ by at most
    one, where the two resizes put a pixel on opposite sides of a rounding
    edge; the test prints how many do."""
    from repro.analytics.scene import generate_segment
    from repro.core.knobs import FidelityOption as RF
    from repro.core.knobs import IngestSpec as RSpec
    from repro_torch.core.knobs import FidelityOption, IngestSpec

    frames, _ = generate_segment(stream, 1)
    n_px = n_diff = 0
    for knobs in [("good", 1.0, 540, 0.5), ("good", 1.0, 270, 0.5),
                  ("best", 0.75, 360, 1.0), ("best", 1.0, 144, 1.0),
                  ("bad", 0.5, 400, 2 / 3)]:
        ref = np.asarray(RT.convert_fidelity(frames, RF(), RF(*knobs),
                                             RSpec()))
        got = T.convert_fidelity(torch.from_numpy(frames), FidelityOption(),
                                 FidelityOption(*knobs), IngestSpec()).numpy()
        assert got.shape == ref.shape
        d = np.abs(got.astype(int) - ref)
        assert d.max() <= 1
        n_px, n_diff = n_px + d.size, n_diff + int((d > 0).sum())
    print(f"{stream}: {n_diff} of {n_px} converted pixels differ by 1")
    assert n_diff <= 1e-3 * n_px


def _fma_lanes(w: np.ndarray, x: np.ndarray, lanes: int) -> np.ndarray:
    """``w @ x`` for float32 (n_out, K) x (K, m), each output summed as
    ``lanes`` fused multiply-add chains over k = l (mod lanes), each begun
    with a plain product, the chains then added pairwise; the fused
    multiply-add emulated in float64, where the product is exact."""
    w64, x64 = w.astype(np.float64), x.astype(np.float64)
    chains = []
    for lane in range(min(lanes, w.shape[1])):
        ks = range(lane, w.shape[1], lanes)
        acc = None
        for k in ks:
            prod = w64[:, k:k + 1] * x64[k][None, :]
            acc = (prod if acc is None else prod + acc).astype(np.float32) \
                .astype(np.float64)
        chains.append(acc.astype(np.float32))
    while len(chains) > 1:
        chains = [chains[i] + chains[i + 1] if i + 1 < len(chains)
                  else chains[i] for i in range(0, len(chains), 2)]
    return chains[0]


def test_resize_product_order_is_one_chain_per_output():
    """The resize fault's product order (ROADMAP §3).  Scene frames cropped
    and resized at the fidelity test's knobs: the plain version's
    products against ``jax.image.resize``, and the same products summed as
    one sequential fused multiply-add chain per output (XLA:CPU's dot
    order) and as 4 chains added pairwise (a vectorised split of the
    sum).  The plain product gives the one-chain sums bit for bit, and the
    split order differs from the reference in at least as many u8 pixels:
    the product order is not what is left of the fault, the weights are.
    The test prints the counts, and how many float32 outputs of the plain
    product equal the one-chain sums (all of them on the hosts measured;
    not asserted, since the CPU GEMM's order is the BLAS build's)."""
    from repro.analytics.scene import generate_segment
    from repro.core.knobs import FidelityOption as RF
    from repro.core.knobs import IngestSpec as RSpec
    from repro_torch.kernels.resize.resize import interp_matrix

    frames = generate_segment("jackson", 1)[0][:2]
    counts = {"plain": 0, "one chain": 0, "4 chains": 0}
    exact = dict.fromkeys(counts, 0)
    n_px = same = 0
    for knobs in [("good", 1.0, 540, 0.5), ("good", 1.0, 270, 0.5),
                  ("best", 0.75, 360, 1.0), ("best", 1.0, 144, 1.0),
                  ("bad", 0.5, 400, 2 / 3)]:
        f_to = RF(*knobs)
        _, h2, w2 = RSpec().resolve(f_to)
        x = np.asarray(RT.center_crop(jnp.asarray(frames, jnp.float32),
                                      min(1.0, f_to.crop)))
        want = np.asarray(RT.resize(jnp.asarray(x), h2, w2))
        wy, wx = interp_matrix(h2, x.shape[1]), interp_matrix(w2, x.shape[2])
        got = {"plain": T.resize(torch.from_numpy(x.copy()), h2, w2).numpy()}
        for name, lanes in (("one chain", 1), ("4 chains", 4)):
            got[name] = np.stack([_fma_lanes(wx, _fma_lanes(wy, f, lanes).T,
                                             lanes).T for f in x])
        n_px += want.size
        same += int((got["plain"] == got["one chain"]).sum())
        for name, out in got.items():
            counts[name] += int((np.round(out) != np.round(want)).sum())
            exact[name] += int((out == want).sum())
    print(f"of {n_px} pixels: u8 differing {counts}; float32 equal to the "
          f"reference {exact}; plain equal to one chain: {same}")
    assert counts["plain"] <= counts["4 chains"]
