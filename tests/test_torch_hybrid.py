"""Port LM, hybrid family (RecurrentGemma: RG-LRU blocks with local
attention), K6's plain version and K4's windowed plain version, against
the JAX reference, on the CPU.

The reference's weights (``repro.models.init_params``) cross over as numpy
arrays through ``repro_torch.models.convert.params_from_numpy``.  The
norms, which the reference initialises to zero, are first set to random
values from numpy in the one tree both packages use, so that the ``1 +
weight`` scaling is held too.  Inputs are made from seeds with numpy.  The
port runs its plain path here (K6's and K4's plain versions); the CUDA
kernels are held against those plain versions by
``tests/test_torch_kernels.py`` (marked ``cuda``) and by
``chip_smoke.py``.

Configs: ``recurrentgemma-9b`` reduced as ``tests/test_serving.py``
reduces it (3 layers: rglru, rglru, attn; d 64, 4 query heads over 1 KV
head, head_dim 16, window 32, GeGLU, tied embeddings scaled by sqrt(d)),
and the same at 4 layers over 2 KV heads, so that an RG-LRU layer follows
the attention layer.

Tolerances, stated up front (float32 throughout; the two sides sum the
matrix products, the softmax and the fresh recurrence in different
orders -- the reference's fresh RG-LRU is an associative scan, K6 is
sequential):
* logits of ``forward`` and ``prefill``: 1e-4 absolute, as
  ``tests/test_serving.py`` holds the reference to itself;
* logits of each ``decode_step``: 2e-4, the same test's bound;
* the ring caches and the RG-LRU states after prefill, the mixer's
  output and states: 1e-5;
* GeGLU: 1e-5;
* K6's plain version vs the reference's Pallas kernel (interpret mode)
  and its associative-scan oracle: 1e-5 (the bound of
  ``tests/test_kernels.py::test_rglru_matches_ref``); against the
  reference's sequential step: 2e-6 of the largest |h|;
* K6's plain gated form vs the reference's a and b followed by its
  ``linear_scan`` or its sequential step: 1e-5, the mixer's bound;
* K4's windowed plain version vs the reference's Pallas kernel and its
  blocked jnp attention: 2e-5;
* greedy tokens: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs
from repro.kernels.attention.attention import flash_attention as ref_attn_kernel
from repro.kernels.rglru.ref import rglru_scan_ref as ref_scan_oracle
from repro.kernels.rglru.rglru import rglru_scan as ref_scan_kernel
from repro.models import attention as ref_attention
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import prefill as ref_prefill
from repro.models import recurrent as ref_recurrent
from repro.train import make_serve_step as ref_make_serve_step

from repro_torch import configs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.rglru.ref import (gate_arrays, rglru_gated_scan_ref,
                                          rglru_scan_ref)
from repro_torch.launch import serve
from repro_torch.models import (HybridLM, decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import MLP
from repro_torch.models.recurrent import RGLRUMixer, rglru_init_state

B = 2
LOGIT_TOL = 1e-4
DECODE_TOL = 2e-4
STATE_TOL = 1e-5
LAYER_TOL = 1e-5
SCAN_TOL = 1e-5
ATTN_TOL = 2e-5

#: case -> extra ``reduced`` arguments
CASES = {"3 layers": {}, "4 layers, kv 2": {"n_layers": 4, "n_kv_heads": 2}}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol, (what, err)
    return err


def _tokens(seed=0, shape=(B, 48), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _randomise_norms(tree: dict, seed: int) -> dict:
    """The tree with its norms (``ln_f`` and each group's ``ln1``,
    ``ln2``) drawn from numpy instead of the reference's zeros."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        return rng.normal(0, 0.2, leaf.shape).astype(leaf.dtype)

    blocks = {}
    for group, leaves in tree["blocks"].items():
        blocks[group] = dict(leaves, ln1=draw(leaves["ln1"]),
                             ln2=draw(leaves["ln2"]))
    return dict(tree, ln_f=draw(tree["ln_f"]), blocks=blocks)


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    """(case, reference cfg, reference params, port cfg, port model): the
    reference's float32 weights, with random norms, in both."""
    extra = CASES[request.param]
    ref_cfg = ref_configs.get_config("recurrentgemma-9b").reduced(**extra)
    cfg = configs.get_config("recurrentgemma-9b").reduced(**extra)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = _randomise_norms(jax.tree.map(np.asarray, params),
                            seed=len(request.param))
    params = jax.tree.map(jnp.asarray, tree)
    return (request.param, ref_cfg, params, cfg,
            params_from_numpy(tree, cfg, device="cpu"))


def test_configs_are_the_published_and_the_reduced_ones():
    """The full config is RecurrentGemma-9B as published (38 layers, 26
    RG-LRU and 12 local attention, 9.40 B parameters); the reduced ones
    have the shapes these tests name, the window masks at S 48."""
    cfg = configs.get_config("recurrentgemma-9b")
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    assert (cfg.n_layers, kinds.count("rglru"), kinds.count("local_attn")) \
        == (38, 26, 12)
    assert (cfg.d_model, cfg.rglru.lru_width, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.rglru.window, cfg.d_ff, cfg.act) == \
        (4096, 4096, 16, 1, 256, 2048, 12288, "geglu")
    assert round(cfg.param_count() / 1e9, 2) == 9.40
    assert not (cfg.logit_softcap or cfg.final_softcap or cfg.post_norm)
    shapes = {}
    for name, extra in CASES.items():
        r = cfg.reduced(**extra)
        shapes[name] = ([r.layer_kind(i) for i in range(r.n_layers)],
                        r.n_kv_heads, r.resolved_head_dim, r.rglru.window)
    assert shapes == {
        "3 layers": (["rglru", "rglru", "local_attn"], 1, 16, 32),
        "4 layers, kv 2": (["rglru", "rglru", "local_attn", "rglru"], 2, 16,
                           32)}
    ref = ref_configs.get_config("recurrentgemma-9b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# K6's plain version

def _ab(b, s, w, seed):
    """a in (0, 1), b small: the reference kernel test's inputs, from
    numpy."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.normal(0, 1, (b, s, w))))
    return a.astype(np.float32), (rng.normal(0, 1, (b, s, w)) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("b,s,w", [(1, 3, 4), (2, 45, 70), (3, 130, 33),
                                   (2, 600, 20)])
def test_plain_scan_matches_reference_kernel_and_oracle(b, s, w):
    """Lengths that are not multiples of the Pallas kernel's 32- or
    512-step chunks, widths not multiples of its 32- or 128-column
    tiles."""
    a, bb = _ab(b, s, w, seed=s + w)
    got = rglru_scan_ref(_t(a), _t(bb))
    assert got.dtype == torch.float32
    for tiles in ((32, 32), (128, 512)):
        kern = ref_scan_kernel(jnp.asarray(a), jnp.asarray(bb),
                               width_tile=tiles[0], seq_chunk=tiles[1],
                               interpret=True)
        _close(got, kern, SCAN_TOL, f"vs Pallas {tiles}")
    _close(got, ref_scan_oracle(jnp.asarray(a), jnp.asarray(bb)), SCAN_TOL,
           "vs linear_scan")
    assert torch.equal(rglru_scan_ref(_t(a), _t(bb), torch.zeros((b, w))), got)


@pytest.mark.parametrize("split", [1, 17, 44])
def test_plain_scan_carries_state_across_a_split(split):
    """Scanning S steps at once equals scanning a prefix and then the rest
    from the prefix's last row -- the prefill/decode hand-off -- bit for
    bit, and from a given state it matches the reference's fresh scan of
    the same sequence with that state folded into the first step."""
    a, bb = _ab(2, 45, 24, seed=split)
    h = rglru_scan_ref(_t(a), _t(bb))
    h1 = rglru_scan_ref(_t(a[:, :split]), _t(bb[:, :split]))
    h2 = rglru_scan_ref(_t(a[:, split:]), _t(bb[:, split:]), h1[:, -1])
    assert torch.equal(torch.cat([h1, h2], dim=1), h)
    h0 = np.random.default_rng(split).normal(0, 1, (2, 24)).astype(np.float32)
    b_folded = bb.copy()
    b_folded[:, 0] += a[:, 0] * h0
    want = ref_scan_oracle(jnp.asarray(a), jnp.asarray(b_folded))
    _close(rglru_scan_ref(_t(a), _t(bb), _t(h0)), want, SCAN_TOL)


def test_plain_step_rounds_as_the_references():
    """The reference's step form (``rglru_mix`` from a state: a
    ``lax.scan`` of ``a_t * h + b_t``, compiled by XLA:CPU) against the
    plain version, which rounds each step once as K6's ``fmaf`` does.
    Prints how many steps equal one rounding and how many two; LLVM's
    contraction into an FMA may depend on the host, so only the stated
    tolerance is asserted."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (1, 4, 65536)).astype(np.float32)
    bb = rng.normal(0, 1, (1, 4, 65536)).astype(np.float32)
    h0 = rng.normal(0, 1, (1, 65536)).astype(np.float32)

    def step(carry, ab):  # the body of the reference's step form
        at, bt = ab
        hn = at * carry + bt
        return hn, hn

    ref = jax.jit(lambda h0, a, b: jax.lax.scan(
        step, h0, (jnp.moveaxis(a, 1, 0), jnp.moveaxis(b, 1, 0)))[1])
    want = np.moveaxis(np.asarray(ref(h0, a, bb)), 0, 1)
    got = rglru_scan_ref(_t(a), _t(bb), _t(h0)).numpy()
    two, h = [], h0
    for t in range(4):
        h = (a[:, t] * h).astype(np.float32) + bb[:, t]
        two.append(h)
    two = np.stack(two, axis=1)
    print(f"reference step vs one rounding: {np.mean(got == want):.4f} "
          f"equal; vs two roundings: {np.mean(two == want):.4f} equal "
          f"({want.size} steps)")
    assert np.max(np.abs(got - want)) <= 2e-6 * np.max(np.abs(want))


def _reference_gated_scan(r, i, xc, a_param, h0=None):
    """The reference's a and b, as ``rglru_mix`` forms them
    (``src/repro/models/recurrent.py:89-92``), then its ``linear_scan``
    (fresh) or its ``lax.scan`` step (from a state)."""
    log_a = -ref_recurrent.C_RGLRU * r * jax.nn.softplus(a_param)
    a = jnp.exp(log_a.astype(jnp.float32))
    gated = (i * xc).astype(jnp.float32)
    b = jnp.sqrt(jnp.maximum(1.0 - a * a, 1e-12)) * gated
    if h0 is None:
        return ref_recurrent.linear_scan(a, b)

    def step(carry, ab):
        at, bt = ab
        hn = at * carry + bt
        return hn, hn

    _, hs = jax.lax.scan(step, h0, (jnp.moveaxis(a, 1, 0),
                                    jnp.moveaxis(b, 1, 0)))
    return jnp.moveaxis(hs, 0, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,with_h0", [(1, True), (45, False), (45, True),
                                       (130, False)])
def test_plain_gated_scan_matches_reference_formation_and_scans(
        dtype, s, with_h0):
    """K6's plain gated form (``rglru_gated_scan_ref``, the port's CPU path
    for the RG-LRU's a, b and scan) against the reference's a and b
    followed by its fresh ``linear_scan`` or its step from a state, on the
    same gates in f32 and in bf16 (r, i and xc rounded to bf16 on both
    sides from the same numpy values)."""
    r, i, xc, a_param, h0 = gate_arrays(B, s, 40, seed=s + len(dtype))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gates = [np.asarray(jnp.asarray(g, jdt).astype(jnp.float32))
             for g in (r, i, xc)]
    h0 = h0 if with_h0 else None
    want = _reference_gated_scan(
        *(jnp.asarray(g, jdt) for g in gates), jnp.asarray(a_param),
        None if h0 is None else jnp.asarray(h0))
    got = rglru_gated_scan_ref(*(_t(g).to(tdt) for g in gates), _t(a_param),
                               None if h0 is None else _t(h0))
    assert got.dtype == torch.float32
    _close(got, want, STATE_TOL, f"{dtype} S {s}")


# ---------------------------------------------------------------------------
# layers: GeGLU, the RG-LRU mixer, windowed attention

def test_geglu_mlp_matches_reference():
    """``wo(gelu(x·wg) * x·wi)`` with the tanh GeLU ``jax.nn.gelu``
    defaults to."""
    params = ref_layers.init_mlp(jax.random.PRNGKey(3), 32, 48, "geglu",
                                 jnp.float32)
    x = np.random.default_rng(2).normal(0, 1, (B, 5, 32)).astype(np.float32)
    mlp = MLP(32, 48, "geglu", torch.float32, "cpu")
    assert {n for n, _ in mlp.named_parameters()} == set(params)
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(mlp, name).copy_(_t(leaf))
    _close(mlp(_t(x)), ref_layers.mlp(params, jnp.asarray(x), "geglu"),
           LAYER_TOL)


def _mixer(cfg, ref_cfg, seed):
    params = ref_recurrent.init_rglru(jax.random.PRNGKey(seed), ref_cfg,
                                      jnp.float32)
    mixer = RGLRUMixer(cfg, torch.float32, "cpu")
    assert {n: tuple(p.shape) for n, p in mixer.named_parameters()} == \
        {n: leaf.shape for n, leaf in params.items()}
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(mixer, name).copy_(_t(leaf))
    assert mixer.a_param.dtype == torch.float32
    return params, mixer


@pytest.mark.parametrize("s", [1, 5, 45])
def test_rglru_mixer_matches_reference_fresh_and_from_a_state(s):
    """``RGLRUMixer`` against ``rglru_mix``: from zero states (the
    reference's associative scan) and from a non-zero state (its
    sequential step), the output and both new states."""
    ref_cfg = ref_configs.get_config("recurrentgemma-9b").reduced()
    cfg = configs.get_config("recurrentgemma-9b").reduced()
    params, mixer = _mixer(cfg, ref_cfg, seed=s)
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)
    w = cfg.rglru.lru_width
    state = {"conv": rng.normal(0, 1, (B, cfg.rglru.conv_width - 1, w))
             .astype(np.float32),
             "h": rng.normal(0, 1, (B, w)).astype(np.float32)}
    for st in (None, state):
        want, want_st = ref_recurrent.rglru_mix(
            params, jnp.asarray(x), ref_cfg,
            None if st is None else jax.tree.map(jnp.asarray, st))
        got, got_st = mixer(_t(x), None if st is None else
                            {k: _t(v) for k, v in st.items()})
        what = "fresh" if st is None else "from a state"
        _close(got, want, STATE_TOL, f"out {what}")
        for name in ("conv", "h"):
            _close(got_st[name], want_st[name], STATE_TOL, f"{name} {what}")
            assert got_st[name].dtype == torch.float32


def test_rglru_mixer_keeps_the_references_dtypes_in_bf16():
    """With bfloat16 weights the output and the conv history are bf16 and
    ``h`` float32, as in the reference; the values agree to bf16
    rounding (5e-2 of the largest |output|: the two round the gates and
    the products at different points)."""
    ref_cfg = ref_configs.get_config("recurrentgemma-9b").reduced()
    cfg = configs.get_config("recurrentgemma-9b").reduced()
    params, mixer = _mixer(cfg, ref_cfg, seed=11)
    params = {k: v if k == "a_param" else v.astype(jnp.bfloat16)
              for k, v in params.items()}
    mixer = mixer.to(torch.bfloat16)
    mixer.a_param.data = mixer.a_param.data.float()
    x = np.random.default_rng(3).normal(0, 1, (B, 9, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    want, want_st = ref_recurrent.rglru_mix(params, jx, ref_cfg)
    got, got_st = mixer(_t(np.asarray(jx, np.float32)).to(torch.bfloat16))
    assert got.dtype == got_st["conv"].dtype == torch.bfloat16
    assert got_st["h"].dtype == torch.float32
    assert want.dtype == want_st["conv"].dtype == jnp.bfloat16
    _close(got, want.astype(jnp.float32),
           5e-2 * float(jnp.abs(want.astype(jnp.float32)).max()))


@pytest.mark.parametrize("s,window", [(40, 16), (48, 32), (70, 16),
                                      (70, 32)])
@pytest.mark.parametrize("kvh", [1, 2])
def test_windowed_plain_attention_matches_reference(s, window, kvh):
    """K4's plain version with a window, in the model's layout with KV
    heads not repeated, against the reference's blocked jnp ``attention``
    and its Pallas kernel (interpret mode, 16-row blocks) on the repeated
    (B, H, S, hd) layout.  S exceeds the window, so the window masks."""
    rng = np.random.default_rng(s + window + kvh)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((B, s, 4, 16), (B, s, kvh, 16),
                             (B, s, kvh, 16)))
    got = attn_ops.gqa_attention(_t(q), _t(k), _t(v), window=window)
    assert not torch.equal(got, attention_ref(_t(q), _t(k), _t(v)))
    want = ref_attention.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   q_block=16, k_block=16)
    _close(got, want, ATTN_TOL, "vs models.attention")
    rep = 4 // kvh
    kern = ref_attn_kernel(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.repeat(jnp.asarray(k).transpose(0, 2, 1, 3), rep, axis=1),
        jnp.repeat(jnp.asarray(v).transpose(0, 2, 1, 3), rep, axis=1),
        causal=True, window=window, q_block=16, k_block=16, interpret=True)
    _close(got, np.asarray(kern).transpose(0, 2, 1, 3), ATTN_TOL,
           "vs Pallas")


# ---------------------------------------------------------------------------
# the model: carried weights, forward, prefill, decode, serve

def test_carried_weights_keep_shapes_and_values(carried):
    _, ref_cfg, params, cfg, model = carried
    assert isinstance(model, HybridLM) and not hasattr(model, "lm_head")
    for group in ("rglru", "attn"):
        tree = params["blocks"][group]
        modules = model.blocks[group]
        assert len(modules) == tree["ln1"].shape[0]
        for i, block in enumerate(modules):
            for sub, leaves in tree.items():
                if isinstance(leaves, dict):
                    for name, leaf in leaves.items():
                        _close(getattr(getattr(block, sub), name), leaf[i],
                               0.0, f"{group}/{sub}/{name}")
                else:
                    _close(getattr(block, sub), leaves[i], 0.0, sub)
    assert model.blocks["rglru"][0].rglru.a_param.dtype == torch.float32
    assert [k for k, _ in model.order] == [
        "rglru" if cfg.layer_kind(i) == "rglru" else "attn"
        for i in range(cfg.n_layers)]


def test_init_params_draws_the_reference_shapes(carried):
    """The port's own init (a torch.Generator) gives every leaf the
    reference's shape and dtype, ``a_param`` in float32 at the softplus
    inverse of 0.65, norms zero and the tied embedding the d^-0.5
    scale."""
    _, _, params, cfg, _ = carried
    model = init_params(cfg, seed=3, device="cpu")
    assert isinstance(model, HybridLM)
    for group in ("rglru", "attn"):
        want = {}
        for sub, leaves in params["blocks"][group].items():
            items = leaves.items() if isinstance(leaves, dict) else \
                [(None, leaves)]
            for name, leaf in items:
                key = sub if name is None else f"{sub}.{name}"
                want[key] = (leaf.shape[1:], str(leaf.dtype))
        for block in model.blocks[group]:
            got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
                   for n, p in block.named_parameters()}
            assert got == want, group
            assert not block.ln1.any() and not block.ln2.any()
    a_param = model.blocks["rglru"][0].rglru.a_param
    _close(a_param, params["blocks"]["rglru"]["rglru"]["a_param"][0], 1e-7)
    assert float(model.embed.abs().max()) <= 2.0 * cfg.d_model ** -0.5 * 1.0001
    assert torch.equal(init_params(cfg, seed=3, device="cpu").embed,
                       model.embed)


def test_forward_matches_reference(carried):
    """B 2, S 48: past the window of 32, so the local layers mask."""
    case, ref_cfg, params, cfg, model = carried
    toks = _tokens()
    want = ref_forward(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                       remat=False)
    err = _close(forward(model, cfg, {"tokens": _t(toks)}), want, LOGIT_TOL)
    print(f"{case}: forward logits max |d| {err:.3g}")


def _ref_cache(ref_cfg, params, toks, max_len):
    return ref_prefill(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                       max_len=max_len, cache_dtype=jnp.float32)


def _check_cache(cache, ref_cache, tol, what):
    assert cache["len"] == int(ref_cache["len"]), what
    for name in ("k", "v"):
        assert len(cache[name]) == ref_cache[name].shape[0]
        for i, ring in enumerate(cache[name]):
            _close(ring, ref_cache[name][i], tol, f"{what} {name} {i}")
    assert len(cache["rec"]) == ref_cache["rec"]["h"].shape[0]
    for i, st in enumerate(cache["rec"]):
        for name in ("conv", "h"):
            _close(st[name], ref_cache["rec"][name][i], tol,
                   f"{what} rec {name} {i}")


@pytest.mark.parametrize("p", [20, 45])
def test_prefill_matches_reference_logits_rings_and_states(carried, p):
    """A prompt below the window (the ring's tail slots take the last
    prompt position's k/v, as the reference's clipped gather fills them)
    and one above it (the ring holds the last 32 positions in ring
    order): logits, every slot of every ring, and the RG-LRU states."""
    _, ref_cfg, params, cfg, model = carried
    toks = _tokens(seed=p)[:, :p]
    want, ref_cache = _ref_cache(ref_cfg, params, toks, 64)
    logits, cache = prefill(model, cfg, {"tokens": _t(toks)}, 64)
    _close(logits, want, LOGIT_TOL)
    assert cache["k"][0].shape[1] == cfg.rglru.window
    _check_cache(cache, ref_cache, STATE_TOL, f"prefill {p}")


def test_decode_steps_wrap_the_ring(carried):
    """A 28-token prefill, then 12 decode steps to 40 tokens: the ring of
    32 wraps at the fifth step.  Each step's logits within 2e-4 of the
    reference's step and of the port's own full forward; the rings and
    states after the last step match the reference's."""
    case, ref_cfg, params, cfg, model = carried
    toks = _tokens(seed=4, shape=(B, 40))
    full = forward(model, cfg, {"tokens": _t(toks)})
    _, ref_cache = _ref_cache(ref_cfg, params, toks[:, :28], 40)
    _, cache = prefill(model, cfg, {"tokens": _t(toks[:, :28])}, 40)
    errs = []
    for t in range(28, 40):
        want, ref_cache = ref_decode_step(
            params, ref_cfg, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            ref_cache)
        got, cache = decode_step(model, cfg, {"tokens": _t(toks[:, t:t + 1])},
                                 cache)
        errs.append(_close(got, want, DECODE_TOL, f"step {t}"))
        _close(got, full[:, t], DECODE_TOL, f"step {t} vs forward")
    _check_cache(cache, ref_cache, 1e-4, "after decode")
    print(f"{case}: decode step logits max |d| {max(errs):.3g}")


def test_ring_buffer_long_decode():
    """The twin of ``tests/test_serving.py::
    test_hybrid_ring_buffer_long_decode``: prefill 8 tokens, decode to 48
    (past the window of 32); the ring keeps 32 positions and each step's
    logits match the reference's full ``forward`` within 2e-4."""
    ref_cfg = ref_configs.get_config("recurrentgemma-9b").reduced()
    cfg = configs.get_config("recurrentgemma-9b").reduced()
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(1))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    toks = _tokens(seed=9, shape=(1, 48))
    full = ref_forward(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                       remat=False)
    _, cache = prefill(model, cfg, {"tokens": _t(toks[:, :8])}, 48)
    assert all(tuple(r.shape) == (1, 32, 1, 16) for r in cache["k"])
    for t in range(8, 48):
        logits, cache = decode_step(model, cfg,
                                    {"tokens": _t(toks[:, t:t + 1])}, cache)
        _close(logits, full[:, t], DECODE_TOL, f"step {t}")
    assert cache["len"] == 48


def test_serve_loop_matches_reference_greedy_tokens(carried):
    """The launcher's greedy loop gives the reference's tokens for the
    same prompts and weights, its 40 tokens wrapping the ring."""
    _, ref_cfg, params, cfg, model = carried
    prompts = _tokens(seed=5, shape=(B, 30))
    toks, _, _ = serve.generate(model, cfg, _t(prompts).long(), 10)
    logits, cache = _ref_cache(ref_cfg, params, prompts, 40)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    step = jax.jit(ref_make_serve_step(ref_cfg))
    want = [tok]
    for _ in range(9):
        tok, cache = step(params, {"tokens": tok[:, None]}, cache)
        want.append(tok)
    assert toks.tolist() == np.stack(want, axis=1).tolist()


def test_init_cache_is_zero_and_shaped_as_reference(carried):
    _, ref_cfg, _, cfg, _ = carried
    for max_len in (16, 64):  # the ring is min(window, max_len) long
        ref = ref_init_cache(ref_cfg, B, max_len, jnp.float32)
        cache = init_cache(cfg, B, max_len, torch.float32, "cpu")
        assert cache["len"] == 0
        for name in ("k", "v"):
            assert len(cache[name]) == ref[name].shape[0]
            for ring in cache[name]:
                assert tuple(ring.shape) == ref[name].shape[1:]
                assert ring.dtype == torch.float32 and not ring.any()
        assert len(cache["rec"]) == ref["rec"]["h"].shape[0]
        for st in cache["rec"]:
            for name in ("conv", "h"):
                assert tuple(st[name].shape) == ref["rec"][name].shape[1:]
                assert not st[name].any()
            assert st["h"].dtype == torch.float32
    st = rglru_init_state(cfg, B, torch.bfloat16, "cpu")
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32


def test_cache_dtype_must_be_the_models(carried):
    """The rings take ``cache_dtype`` as the reference's ``prefill`` does:
    bfloat16 rings under float32 weights (the reference's default) are
    taken and decoded over, the RG-LRU states keeping the model's dtype;
    the model's dtype by default."""
    _, _, _, cfg, model = carried
    toks = _t(_tokens()[:, :12])
    _, cache = prefill(model, cfg, {"tokens": toks}, 16, torch.bfloat16)
    assert all(r.dtype == torch.bfloat16 for r in cache["k"] + cache["v"])
    assert all(st["conv"].dtype == torch.float32 for st in cache["rec"])
    logits, cache = decode_step(model, cfg, {"tokens": toks[:, :1]}, cache)
    assert logits.dtype == torch.float32 and cache["len"] == 13
    _, cache = prefill(model, cfg, {"tokens": toks}, 16)
    assert cache["k"][0].dtype == torch.float32


def test_hybrid_models_need_a_card_unless_cpu_is_asked(monkeypatch, carried):
    """``HybridLM``, ``init_params``, ``init_cache`` and
    ``params_from_numpy`` default to the card and raise without one."""
    _, _, params, cfg, _ = carried
    tree = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: init_params(cfg), lambda: HybridLM(cfg),
                  lambda: init_cache(cfg, B, 16),
                  lambda: params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_launcher_serves_hybrid_on_cpu():
    toks = serve.main(["--arch", "recurrentgemma-9b", "--device", "cpu",
                       "--new-tokens", "3", "--prompt-len", "40", "--batch",
                       "2"])
    assert toks.shape == (2, 3)
