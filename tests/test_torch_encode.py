"""The port's encoder (K3's encoder form, ``kernels/dct8``) on the CPU: its
plain version against a step-by-step composition of the K3 and K1 plain
versions (equal, symbol for symbol), each chunk against the JAX
reference's ``_encode_chunk`` (the codec's bound: at most 0.5% of the
symbols differ, each by at most 2, as ``tests/test_torch_codec.py`` states
for whole blobs), the wrapper's refusals, and each defect of
``ref.ENCODE_MUTANTS`` visible on the frames the card tests use.  The
CUDA kernel itself is held against the stepped K3 + K1 route and the plain
version on the card by ``tests/test_torch_kernels.py`` (marked ``cuda``)
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.codec import segment as RS

from repro_torch.codec import segment as S
from repro_torch.kernels.dct8 import dct8 as K13
from repro_torch.kernels.dct8 import ops as dct_ops
from repro_torch.kernels.dct8.ref import (ENCODE_MUTANTS,
                                          dct8_dequantize_ref,
                                          dct8_encode_chunks_ref,
                                          dct8_quantize_ref,
                                          encode_chunks_stepped,
                                          encode_inputs, encode_mutant)

#: (n, k): a ragged tail, k >= n (one short chunk), every frame intra
CHUNKINGS = [(13, 5), (13, 50), (6, 1)]


def _frames(n, h=48, w=64, seed=0) -> np.ndarray:
    """The frames the card tests use (``ref.encode_inputs``: black and
    white squares whose edges ring past 0 and 255), made on the CPU."""
    return encode_inputs(n, h, w, seed).numpy()


def _composed(frames: np.ndarray, k: int, qs: float) -> np.ndarray:
    """The encoder written out: chunk by chunk, frame by frame, K3's and
    K1's plain versions on one frame at a time, add, clamp."""
    n = len(frames)
    ke = min(k, n)
    chunks = []
    for start in range(0, n, k):
        last = min(start + k, n) - 1
        pred = torch.full(frames.shape[1:], 128.0)
        syms = []
        for t in range(ke):
            x = torch.from_numpy(frames[min(start + t, last)]).float()
            sym = dct8_quantize_ref((x - pred)[None], qs)
            pred = torch.clamp(pred + dct8_dequantize_ref(sym, qs)[0],
                               0.0, 255.0)
            syms.append(sym[0].numpy())
        chunks.append(np.stack(syms))
    return np.stack(chunks)


@pytest.mark.parametrize("n,k", CHUNKINGS)
def test_plain_encoder_is_the_stepped_composition(n, k):
    f = _frames(n, seed=n + k)
    got = dct8_encode_chunks_ref(torch.from_numpy(f), k, 2.0)
    assert got.dtype == torch.int16
    assert tuple(got.shape) == (-(-n // k), min(k, n), 6, 8, 8, 8)
    assert np.array_equal(got.numpy(), _composed(f, k, 2.0))


@pytest.mark.parametrize("qs", [2.0, 6.0])
@pytest.mark.parametrize("n,k", CHUNKINGS)
def test_encoder_chunks_match_reference_encode_chunk(n, k, qs):
    f = _frames(n, seed=7 * n + k)
    got = S._encode_chunks(torch.from_numpy(f), k, qs).numpy()
    ke = min(k, n)
    want = np.stack([np.asarray(RS._encode_chunk(
        jnp.asarray(RS._pad_tail(f[start:start + k], ke), jnp.float32),
        jnp.float32(qs), backend="jnp")) for start in range(0, n, k)])
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want)
    n_diff = int((diff > 0).sum())
    print(f"n={n} k={k} qs={qs}: {n_diff} of {got.size} symbols differ, "
          f"max |d|={diff.max()}")
    assert n_diff <= 0.005 * got.size and diff.max() <= 2


def test_encoder_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper takes (n, h, w) uint8 with h and w multiples of 8, on
    the card only; the dispatch sends a CPU tensor to the plain version."""
    f = torch.from_numpy(_frames(3, 16, 24))
    with pytest.raises(ValueError, match="CUDA"):
        K13.dct8_encode_chunks(f, 2, 2.0)
    with pytest.raises(ValueError, match="uint8"):
        K13.dct8_encode_chunks(f.float(), 2, 2.0)
    with pytest.raises(ValueError, match="uint8"):
        K13.dct8_encode_chunks(f[0], 2, 2.0)
    for bad in (f[:, :12], f[:, :, :20]):
        with pytest.raises(ValueError, match="multiple of 8"):
            K13.dct8_encode_chunks(bad.contiguous(), 2, 2.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        K13.dct8_quantize(f[:, :12].float().contiguous(), 2.0)
    assert torch.equal(dct_ops.dct_encode_chunks(f, 2, 2.0),
                       dct8_encode_chunks_ref(f, 2, 2.0))


@pytest.mark.parametrize("mutant", ENCODE_MUTANTS)
def test_each_encoder_mutant_changes_the_symbols(mutant):
    """On ragged, saturated frames (n 13, k 5: a tail of 3 padded to 5)
    every defect of ``ENCODE_MUTANTS`` changes symbols, so a check that
    holds the kernel against the plain version sees it."""
    f = torch.from_numpy(_frames(13, seed=5))
    good = encode_chunks_stepped(f, 5, 2.0)
    bad = encode_mutant(mutant, f, 5, 2.0)
    n_diff = int((good != bad).sum())
    print(f"{mutant}: {n_diff} of {good.numel()} symbols differ")
    assert n_diff > 0
    with pytest.raises(ValueError, match="mutant"):
        encode_mutant("no such defect", f, 5, 2.0)
