"""Port LM, gemma2 (Gemma2-2B), and K4's logit soft-cap and decode-form
window, against the JAX reference, on the CPU.

The reference's weights (``repro.models.init_params``) cross over as numpy
arrays through ``repro_torch.models.convert.params_from_numpy``.  The
norms, which the reference initialises to zero -- ``ln_f``, ``ln1``,
``ln2`` and gemma2's post-norms ``pn1``/``pn2`` -- are first set to random
values from numpy in the one tree both packages use, so that each ``1 +
weight`` scaling is held too.  Inputs are made from seeds with numpy.  The
port runs its plain path here (K4's plain version); the CUDA kernel is
held against that plain version by ``tests/test_torch_kernels.py``
(marked ``cuda``) and by ``chip_smoke.py``.

Configs: ``gemma2-2b`` reduced as ``tests/test_serving.py`` reduces it (d
64, 4 heads over 2, head_dim 16, GeGLU d_ff 128, vocab 512, tied), with 4
layers (local, global, local, global; ``reduced()`` caps the window at
16), the published caps (attention 50, final 30); and the same with both
caps at 1.0, where they act on every score and logit (at this width the
scores stay far under 50).  S 48 and prefill 36 + 12 decode steps run past
the window of 16, so both masks act.

Tolerances, stated up front (float32 weights; the two sides sum the
products and the softmax in different orders):
* logits of ``forward`` and ``prefill``: 1e-4 absolute, as
  ``tests/test_serving.py`` holds the reference to itself;
* logits of each ``decode_step`` over a float32 cache: 2e-4, the same
  test's bound; the caches after prefill and decode: 1e-5;
* over the reference's default bfloat16 cache: both write the same
  float32 k/v rounded to bfloat16 (the prompt's positions agree element by
  element within one bf16 ulp, at most 2^-7 of the value, where the
  float32 k/v straddle a rounding boundary);
  the port attends in float32 (the TPU kernel's function), the
  reference rounds p and the attention output to bfloat16, which alone
  moves the reference's own logits by 3.8e-3 (published caps) and 1.4e-2
  (caps at 1.0) of the largest |logit| between its float32 and bfloat16
  caches on these inputs: each step's logits within 2e-2 of the largest
  |logit| (the decoded positions' k/v within 2e-2 of the largest |k| or
  |v|), greedy tokens equal but where the reference's own top-2 margin is
  under that bound;
* K4's capped plain version vs the reference's Pallas kernel (interpret
  mode) and vs ``decode_attention``: 2e-5 in float32 (the bound of
  ``tests/test_kernels.py``); vs ``decode_attention`` over a bfloat16
  cache, which rounds p and its output to bfloat16: 2^-7 of the largest
  |output|;
* the capped inputs' largest score exceeds the cap by construction
  (``ref.scores_over_cap``), and the uncapped plain version lies outside
  ``ref.HOLD`` of the capped one, so the tanh acted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs
from repro.kernels.attention.attention import flash_attention as ref_kernel
from repro.models import attention as ref_attention
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill

from repro_torch import configs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import (attention_ref, hold_ratio,
                                               scores_over_cap)
from repro_torch.models import (DenseLM, decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models.convert import params_from_numpy

B, S, P = 2, 48, 36
LOGIT_TOL = 1e-4
DECODE_TOL = 2e-4
CACHE_TOL = 1e-5
BF16_CACHE_TOL = 2e-2  # of the largest |logit|, |k| or |v|
KERNEL_TOL = 2e-5
BF16_DECODE_TOL = 2 ** -7  # of the largest |output|
CAP = 50.0  # gemma2's attention soft-cap

#: case -> caps replacing the published ones (none: as published)
CASES = {"gemma2-2b": {},
         "gemma2-2b-tight-caps": {"logit_softcap": 1.0, "final_softcap": 1.0}}
CACHES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol, (what, err)
    return err


def _tokens(seed=0, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _same_tokens_or_near_ties(got, want, tol):
    """Greedy tokens of the port's logits ``got`` (B, vocab) equal the
    reference's, except where the reference's own top-2 margin is under
    ``tol`` (a near-tie the stated tolerance cannot order)."""
    want = np.asarray(want, np.float32)
    top2 = np.sort(want, axis=-1)[:, -2:]
    for row, tok in enumerate(torch.argmax(got, -1).tolist()):
        if tok != int(np.argmax(want[row])):
            margin = float(top2[row, 1] - top2[row, 0])
            assert margin <= tol, (row, tok, margin)
            print(f"row {row}: token {tok} vs the reference's "
                  f"{int(np.argmax(want[row]))}, a near-tie (margin "
                  f"{margin:.3g} <= {tol:.3g})")


def _configs(case):
    caps = CASES[case]
    return tuple(dataclasses.replace(
        zoo.get_config("gemma2-2b").reduced(n_layers=4), **caps)
        for zoo in (ref_configs, configs))


def _randomise_norms(tree: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def draw(leaf):
        return rng.normal(0, 0.2, leaf.shape).astype(leaf.dtype)

    blocks = dict(tree["blocks"])
    for name in ("ln1", "ln2", "pn1", "pn2"):
        blocks[name] = draw(blocks[name])
    return dict(tree, ln_f=draw(tree["ln_f"]), blocks=blocks)


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    """(case, reference cfg, reference params, port cfg, port model): the
    reference's float32 weights, with random norms, in both."""
    ref_cfg, cfg = _configs(request.param)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = _randomise_norms(jax.tree.map(np.asarray, params),
                            seed=len(request.param))
    return (request.param, ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# the model: layers, weights, forward

def test_layers_alternate_local_and_global_as_the_reference(carried):
    """Even layers are local (``cfg.layer_kind``, the reference's rule):
    their blocks attend within ``local_window`` keys, the odd ones over
    all; every block soft-caps at ``logit_softcap`` and has post-norms."""
    _, ref_cfg, _, cfg, model = carried
    kinds = [ref_cfg.layer_kind(i) for i in range(ref_cfg.n_layers)]
    assert kinds == ["local_attn", "attn"] * 2
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == kinds
    assert [b.window for b in model.blocks] == [16, 0, 16, 0]
    assert cfg.local_window == ref_cfg.local_window == 16
    assert all(b.logit_cap == cfg.logit_softcap and b.post_norm
               for b in model.blocks)


def test_carried_weights_keep_the_post_norms(carried):
    _, _, params, cfg, model = carried
    assert isinstance(model, DenseLM)
    for i, block in enumerate(model.blocks):
        for name in ("ln1", "ln2", "pn1", "pn2"):
            _close(getattr(block, name), params["blocks"][name][i], 0.0, name)
            assert bool(getattr(block, name).any())


def test_init_params_draws_the_reference_leaves():
    """The port's own init gives the blocks the reference's leaves (the
    post-norms among them), their shapes and dtypes, the norms zero."""
    ref_cfg, cfg = _configs("gemma2-2b")
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = init_params(cfg, seed=3, device="cpu")
    block = model.blocks[0]
    for name in ("ln1", "ln2", "pn1", "pn2"):
        leaf = params["blocks"][name]
        assert tuple(getattr(block, name).shape) == leaf.shape[1:]
        assert getattr(block, name).dtype == torch.float32
        assert not getattr(block, name).any()
    names = {n.split(".", 2)[2] for n, _ in model.named_parameters()
             if n.startswith("blocks.0.")}
    ref_names = {"/".join(str(k.key) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     params["blocks"])[0]}
    assert names == {n.replace("/", ".") for n in ref_names}


def test_forward_matches_reference(carried):
    """S 48 over a window of 16: both masks act."""
    case, ref_cfg, params, cfg, model = carried
    toks = _tokens()
    want = ref_forward(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                       remat=False)
    err = _close(forward(model, cfg, {"tokens": _t(toks)}), want, LOGIT_TOL)
    print(f"{case}: forward logits max |d| {err:.3g}")


def test_window_and_caps_change_the_logits(carried, monkeypatch):
    """The port's forward without the local layers' window, and (where the
    case's caps act) without the attention or the final soft-cap, lies
    far outside the tolerance of its own logits: each feature the parity
    test holds is one that moves them."""
    case, _, _, cfg, model = carried
    toks = _t(_tokens(seed=1))
    want = forward(model, cfg, {"tokens": toks})

    def off(**attrs):
        with monkeypatch.context() as m:
            for obj, name, value in attrs.values():
                m.setattr(obj, name, value)
            return float((forward(model, cfg, {"tokens": toks})
                          - want).abs().max())

    no_window = {f"w{i}": (b, "window", 0) for i, b in enumerate(model.blocks)}
    assert off(**no_window) > 100 * LOGIT_TOL
    if CASES[case]:
        no_cap = {f"c{i}": (b, "logit_cap", 0.0)
                  for i, b in enumerate(model.blocks)}
        assert off(**no_cap) > 100 * LOGIT_TOL
        final = dataclasses.replace(cfg, final_softcap=0.0)
        assert off(cfg=(model, "cfg", final)) > 100 * LOGIT_TOL


# ---------------------------------------------------------------------------
# serving: prefill and decode past the window, at both cache dtypes

@pytest.mark.parametrize("cache", sorted(CACHES))
def test_prefill_and_decode_past_the_window_match_reference(carried, cache):
    """A 36-token prefill (past the window of 16), then 12 decode steps to
    48 over a cache of ``cache`` dtype, the reference's default bfloat16
    included: the prefill's logits, each step's logits and the caches
    against the reference's ``prefill`` / ``decode_step`` at the same
    cache dtype; each step's greedy tokens equal to the reference's, or a
    near-tie of its own."""
    case, ref_cfg, params, cfg, model = carried
    dtype, ref_dtype = CACHES[cache]
    toks = _tokens(seed=4)
    want, ref_cache = ref_prefill(params, ref_cfg,
                                  {"tokens": jnp.asarray(toks[:, :P])},
                                  max_len=S, cache_dtype=ref_dtype)
    logits, kv = prefill(model, cfg, {"tokens": _t(toks[:, :P])}, S, dtype)
    _close(logits, want, LOGIT_TOL, "prefill")
    assert kv["k"][0].dtype == dtype and kv["len"] == P
    full = forward(model, cfg, {"tokens": _t(toks)})
    errs = []
    for t in range(P, S):
        want, ref_cache = ref_decode_step(
            params, ref_cfg, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            ref_cache)
        got, kv = decode_step(model, cfg, {"tokens": _t(toks[:, t:t + 1])},
                              kv)
        if dtype == torch.float32:
            errs.append(_close(got, want, DECODE_TOL, f"step {t}"))
            _close(got, full[:, t], DECODE_TOL, f"step {t} vs forward")
            tol = DECODE_TOL
        else:
            scale = float(np.max(np.abs(np.asarray(want, np.float32))))
            tol = BF16_CACHE_TOL * scale
            errs.append(_close(got, want, tol, f"step {t}") / scale)
        _same_tokens_or_near_ties(got, want, tol)
    assert kv["len"] == S == int(ref_cache["len"])
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            ref_kv = np.asarray(ref_cache[name][i], np.float32)
            if dtype == torch.float32:
                _close(kv[name][i], ref_kv, CACHE_TOL, f"{name} {i}")
            else:
                # the prompt's k/v: one bf16 ulp apart at most where the
                # float32 k/v straddle a rounding boundary; the decoded
                # tokens' k/v also carry the earlier layers' rounding
                d = np.abs(kv[name][i].float().numpy() - ref_kv)
                assert np.all(d[:, :P] <= 2 ** -7 * np.abs(ref_kv[:, :P])
                              + CACHE_TOL), (name, i)
                assert d.max() <= BF16_CACHE_TOL * np.abs(ref_kv).max(), \
                    (name, i)
    print(f"{case}, {cache} cache: decode step logits max |d| "
          f"{max(errs):.3g}")


def test_init_cache_takes_either_dtype_shaped_as_reference(carried):
    _, ref_cfg, _, cfg, _ = carried
    for dtype, ref_dtype in CACHES.values():
        ref = ref_init_cache(ref_cfg, B, S, ref_dtype)
        cache = init_cache(cfg, B, S, dtype, "cpu")
        assert len(cache["k"]) == ref["k"].shape[0] == cfg.n_layers
        for kc in cache["k"] + cache["v"]:
            assert tuple(kc.shape) == ref["k"].shape[1:]
            assert kc.dtype == dtype and not kc.any()


# ---------------------------------------------------------------------------
# K4's plain version: the soft-cap in both forms, the decode-form window

def _capped_qkv(b, sq, sk, h, kvh, hd, seed, q_offset=0):
    """q (b, sq, h, hd), k, v (b, sk, kvh, hd) float32 from numpy: keys at
    30 times a standard normal (scores spread far past the cap), with key
    row ``q_offset + i`` a multiple of query row i (``scores_over_cap``:
    a score of 2·CAP in every row, by construction)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32))
    k = torch.from_numpy(
        30 * rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32))
    return q, scores_over_cap(q, k, CAP, q_offset), v


def _max_score(q, k, q_offset=0):
    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    kk = k.float().repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kk)
    return float(s.max())


@pytest.mark.parametrize("s,window", [(130, 0), (130, 16), (99, 40),
                                      (192, 64)])
@pytest.mark.parametrize("grouped", [False, True])
def test_capped_plain_attention_matches_reference_kernel(s, window, grouped):
    """The plain version with ``logit_cap`` 50 (and a window) in the
    model's layout, KV heads not repeated, against the Pallas kernel with
    the same cap (interpret mode, 64-row blocks) on the repeated (B, H, S,
    hd) layout.  Every row's scores exceed the cap, and the uncapped plain
    version fails ``ref.HOLD`` against the capped one."""
    h, kvh, hd = 4, (2 if grouped else 4), 32
    q, k, v = _capped_qkv(2, s, s, h, kvh, hd, seed=s + window)
    assert _max_score(q, k) > CAP
    got = attention_ref(q, k, v, window=window, logit_cap=CAP)
    rep = h // kvh
    jq, jk, jv = (jnp.asarray(t.numpy()).transpose(0, 2, 1, 3)
                  for t in (q, k, v))
    kern = ref_kernel(jq, jnp.repeat(jk, rep, axis=1),
                      jnp.repeat(jv, rep, axis=1), causal=True, window=window,
                      logit_cap=CAP, q_block=64, k_block=64, interpret=True)
    err = _close(got, np.asarray(kern).transpose(0, 2, 1, 3), KERNEL_TOL,
                 "vs kernel")
    assert hold_ratio(attention_ref(q, k, v, window=window), got) > 1
    assert torch.equal(attn_ops.gqa_attention(q, k, v, window=window,
                                              logit_cap=CAP), got)
    print(f"capped S {s} window {window}: max |d| vs the Pallas kernel "
          f"{err:.3g}")


@pytest.mark.parametrize("cache_len", [1, 17, 40])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_capped_windowed_decode_form_matches_decode_attention(cache_len,
                                                              window, cache):
    """Sq 1 at ``q_offset = len - 1``, ``k_len = len``, with gemma2's cap
    and with and without its window, over a 40-position cache whose tail
    holds other values: the reference's ``decode_attention(..., window,
    logit_cap)``, over a float32 cache and with a float32 query over a
    bfloat16 cache (the reference's default).  The query's scores exceed
    the cap; dropping the cap (where more than one key is seen), or the
    window where it masks, fails the hold."""
    dtype, ref_dtype = CACHES[cache]
    q, k, v = _capped_qkv(2, 1, 40, 8, 4, 32, seed=cache_len + window,
                          q_offset=cache_len - 1)
    k, v = k.to(dtype), v.to(dtype)
    assert _max_score(q, k, cache_len - 1) > CAP
    jq = jnp.asarray(q.numpy())
    jk, jv = (jnp.asarray(t.float().numpy(), ref_dtype) for t in (k, v))
    want = ref_attention.decode_attention(jq, jk, jv, cache_len,
                                          window=window, logit_cap=CAP)
    got = attn_ops.gqa_attention(q, k, v, q_offset=cache_len - 1,
                                 k_len=cache_len, window=window,
                                 logit_cap=CAP)
    assert got.dtype == torch.float32
    want32 = np.asarray(want, np.float32)
    tol = KERNEL_TOL if dtype == torch.float32 else \
        BF16_DECODE_TOL * float(np.max(np.abs(want32)))
    _close(got, want32, tol)
    if cache_len > 1:  # one key alone takes all the weight, capped or not
        uncapped = attention_ref(q, k, v, cache_len - 1, cache_len, window)
        assert hold_ratio(uncapped, got) > 1
    if window and cache_len > window:
        wide = attention_ref(q, k, v, cache_len - 1, cache_len,
                             logit_cap=CAP)
        assert hold_ratio(wide, got) > 1
