"""Port LM, dense family (StarCoder2, SmolLM, Qwen1.5), and K4's plain
version, against the JAX reference, on the CPU.

The reference's weights (``repro.models.init_params``) cross over as numpy
arrays through ``repro_torch.models.convert.params_from_numpy``.  The
leaves the reference initialises to zero -- the norms and the qkv biases
-- are first set to random values from numpy in the one tree both
packages use, so that the ``1 + weight`` scaling and the bias add are
held too.  Inputs are made from seeds with numpy.  The port runs its
plain path here (K4's plain version); the CUDA kernel is held against that
plain version by ``tests/test_torch_kernels.py`` (marked ``cuda``) and by
``chip_smoke.py``.

Configs, reduced as ``tests/test_serving.py`` reduces them (d 64, 4 query
heads, head_dim 16): ``starcoder2-3b`` (MQA, 4 heads over 1; qkv bias,
RoPE at 1e5, GeLU MLP, untied), the same with 2 KV heads (GQA of 2
groups), ``smollm-135m`` (MQA; SiLU-gated MLP, tied embeddings scaled by
sqrt(d)) and ``qwen1.5-0.5b`` (MHA, 4 over 4; qkv bias, SiLU, tied).

Tolerances, stated up front (float32 throughout; the two sides sum the
matrix products and the softmax in different orders):
* logits of ``forward`` and ``prefill``: 1e-4 absolute, as
  ``tests/test_serving.py`` holds the reference to itself;
* logits of each ``decode_step``: 2e-4, the same test's bound;
* the KV cache after prefill: 1e-5 (one projection, bias and rotation);
* RoPE, the MLPs and the qkv projection: 1e-5;
* K4's plain version vs the reference's Pallas kernel (interpret mode)
  and its jnp oracle: 2e-5 in float32, 2e-2 in bfloat16 (the bounds of
  ``tests/test_kernels.py``); vs ``decode_attention``: 1e-5;
* greedy tokens of the serve loop: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs
from repro.kernels.attention.attention import flash_attention as ref_kernel
from repro.kernels.attention.ops import gqa_attention as ref_gqa
from repro.models import attention as ref_attention
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import layers as ref_layers
from repro.train import make_serve_step as ref_make_serve_step

from repro_torch import configs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.launch import serve
from repro_torch.models import (DenseLM, decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models.attention import Attention
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import MLP, apply_rope, rope_table

B, S, P = 2, 16, 12  # as tests/test_serving.py
LOGIT_TOL = 1e-4
DECODE_TOL = 2e-4
CACHE_TOL = 1e-5
LAYER_TOL = 1e-5

#: case -> (arch, extra ``reduced`` arguments)
CASES = {
    "starcoder2-3b": ("starcoder2-3b", {}),
    "starcoder2-3b-kv2": ("starcoder2-3b", {"n_kv_heads": 2}),
    "smollm-135m": ("smollm-135m", {}),
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}),
}


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


def _tokens(seed=0, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _randomise_zero_leaves(tree: dict, seed: int) -> dict:
    """The tree with its norms (``ln_f``, ``blocks/ln1``, ``blocks/ln2``)
    and qkv biases drawn from numpy instead of the reference's zeros."""
    rng = np.random.default_rng(seed)

    def draw(leaf, scale):
        return rng.normal(0, scale, leaf.shape).astype(leaf.dtype)

    tree = dict(tree, ln_f=draw(tree["ln_f"], 0.2))
    blocks = dict(tree["blocks"])
    for name in ("ln1", "ln2"):
        blocks[name] = draw(blocks[name], 0.2)
    attn = dict(blocks["attn"])
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = draw(attn[name], 0.5)
    blocks["attn"] = attn
    tree["blocks"] = blocks
    return tree


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    """(case, reference cfg, reference params, port cfg, port model): the
    reference's float32 weights, with random norms and biases, in both."""
    arch, extra = CASES[request.param]
    ref_cfg = ref_configs.get_config(arch).reduced(**extra)
    cfg = configs.get_config(arch).reduced(**extra)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = _randomise_zero_leaves(jax.tree.map(np.asarray, params),
                                  seed=len(request.param))
    params = jax.tree.map(jnp.asarray, tree)
    return (request.param, ref_cfg, params, cfg,
            params_from_numpy(tree, cfg, device="cpu"))


def test_cases_cover_mqa_gqa_and_mha():
    kinds = {}
    for name, (arch, extra) in CASES.items():
        cfg = configs.get_config(arch).reduced(**extra)
        kinds[name] = (cfg.n_heads, cfg.n_kv_heads, cfg.qkv_bias,
                       cfg.tie_embeddings, cfg.act)
    assert kinds == {
        "starcoder2-3b": (4, 1, True, False, "gelu"),
        "starcoder2-3b-kv2": (4, 2, True, False, "gelu"),
        "smollm-135m": (4, 1, False, True, "silu"),
        "qwen1.5-0.5b": (4, 4, True, True, "silu"),
    }


# ---------------------------------------------------------------------------
# layers

def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (B, 5, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(5), 4091 + np.arange(5)]).astype(np.int32)
    for theta in (1e4, 1e5):
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = apply_rope(_t(x), rope_table(_t(pos), 16, theta))
        _close(got, want, LAYER_TOL, f"theta {theta}")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    """The gated SiLU and the plain GeLU MLP (tanh GeLU, as
    ``jax.nn.gelu`` defaults to)."""
    params = ref_layers.init_mlp(jax.random.PRNGKey(3), 32, 48, act,
                                 jnp.float32)
    x = np.random.default_rng(2).normal(0, 1, (B, 5, 32)).astype(np.float32)
    mlp = MLP(32, 48, act, torch.float32, "cpu")
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(mlp, name).copy_(_t(leaf))
    _close(mlp(_t(x)), ref_layers.mlp(params, jnp.asarray(x), act),
           LAYER_TOL)


def test_qkv_project_matches_reference(carried):
    _, ref_cfg, params, cfg, model = carried
    x = np.random.default_rng(4).normal(0, 1, (B, 7, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (B, 7)).astype(np.int32)
    layer = jax.tree.map(lambda p: p[1], params["blocks"]["attn"])
    want = ref_attention.qkv_project(
        layer, jnp.asarray(x), ref_cfg, jnp.asarray(pos),
        lambda t, p: ref_layers.apply_rope(t, p, ref_cfg.rope_theta))
    attn = model.blocks[1].attn
    got = attn.qkv_project(_t(x), rope_table(_t(pos), cfg.resolved_head_dim,
                                             cfg.rope_theta))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, LAYER_TOL, name)


# ---------------------------------------------------------------------------
# K4's plain version vs the reference kernel, its oracle, decode_attention

def _qkv(b, h, kvh, sq, sk, hd, dtype, seed):
    """q (b, sq, h, hd), k, v (b, sk, kvh, hd) from numpy, rounded to
    ``dtype`` once and handed to both packages bit for bit."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd)):
        x = jnp.asarray(rng.normal(0, 1, shape).astype(np.float32), dtype)
        out.append((x, torch.from_numpy(np.array(x, np.float32)).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)))
    return out


# the causal cases of tests/test_kernels.py with no window and no soft-cap
@pytest.mark.parametrize("b,h,s,hd,dtype",
                         [(2, 3, 192, 64, jnp.float32),
                          (1, 2, 130, 64, jnp.float32),
                          (1, 2, 128, 64, jnp.bfloat16)])
@pytest.mark.parametrize("grouped", [False, True])
def test_plain_attention_matches_reference_kernel_and_oracle(b, h, s, hd,
                                                             dtype, grouped):
    """The plain version in the model's layout, KV heads not repeated,
    against the Pallas kernel (interpret mode, 64-row blocks, so S = 130
    leaves a ragged block) on the repeated (B, H, S, hd) layout, and
    against ``attention_ref`` through the reference's ``gqa_attention``."""
    kvh = 1 if grouped else h
    (jq, q), (jk, k), (jv, v) = _qkv(b, h, kvh, s, s, hd, dtype, seed=s + h)
    got = attention_ref(q, k, v)
    assert got.dtype == q.dtype
    rep = h // kvh
    kern = ref_kernel(jq.transpose(0, 2, 1, 3),
                      jnp.repeat(jk.transpose(0, 2, 1, 3), rep, axis=1),
                      jnp.repeat(jv.transpose(0, 2, 1, 3), rep, axis=1),
                      causal=True, q_block=64, k_block=64, interpret=True)
    oracle = ref_gqa(jq, jk, jv, causal=True, use_pallas=False)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    _close(got, np.asarray(kern.transpose(0, 2, 1, 3), np.float32), tol,
           "vs kernel")
    _close(got, np.asarray(oracle, np.float32), tol, "vs oracle")
    assert torch.equal(attn_ops.gqa_attention(q, k, v), got)


@pytest.mark.parametrize("h,kvh", [(4, 1), (4, 2), (3, 3), (24, 2)])
@pytest.mark.parametrize("cache_len", [1, 7, 40])
def test_plain_decode_form_matches_decode_attention(h, kvh, cache_len):
    """Sq = 1 at ``q_offset = len - 1`` and ``k_len = len`` over a cache
    of 40 positions whose tail holds other values than zeros (so the mask
    must act) is the reference's ``decode_attention``."""
    (jq, q), (jk, k), (jv, v) = _qkv(2, h, kvh, 1, 40, 16, jnp.float32,
                                     seed=cache_len + h)
    want = ref_attention.decode_attention(jq, jk, jv, cache_len)
    got = attn_ops.gqa_attention(q, k, v, q_offset=cache_len - 1,
                                 k_len=cache_len)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the model: carried weights, forward, prefill, decode, serve

def test_carried_weights_keep_shapes_and_values(carried):
    _, ref_cfg, params, cfg, model = carried
    blocks = params["blocks"]
    assert len(model.blocks) == cfg.n_layers == blocks["ln1"].shape[0]
    assert hasattr(model, "lm_head") == (not cfg.tie_embeddings)
    for i, block in enumerate(model.blocks):
        for name, leaf in blocks["attn"].items():
            _close(getattr(block.attn, name), leaf[i], 0.0, name)
        for name, leaf in blocks["mlp"].items():
            _close(getattr(block.mlp, name), leaf[i], 0.0, name)
        _close(block.ln2, blocks["ln2"][i], 0.0, "ln2")
        assert bool(block.ln1.any()) and bool(block.ln2.any())
    if cfg.qkv_bias:
        assert bool(model.blocks[0].attn.bq.any())


def test_init_params_draws_the_reference_shapes(carried):
    """The port's own init (a torch.Generator) gives every leaf the
    reference's shape and dtype, norms and biases zero, and the tied
    embedding the d^-0.5 scale."""
    _, ref_cfg, params, cfg, _ = carried
    model = init_params(cfg, seed=3, device="cpu")
    assert isinstance(model, DenseLM)
    ref_shapes = {name: leaf.shape for name, leaf in params.items()
                  if name != "blocks"}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()
            if not n.startswith("blocks")} == ref_shapes
    block = model.blocks[0]
    for group in ("attn", "mlp"):
        for name, leaf in params["blocks"][group].items():
            assert tuple(getattr(getattr(block, group), name).shape) == \
                leaf.shape[1:], name
    assert not model.ln_f.any() and not block.ln1.any() \
        and not block.ln2.any()
    if cfg.qkv_bias:
        assert not block.attn.bq.any() and not block.attn.bv.any()
    limit = 2.0 * (cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0)
    assert float(model.embed.abs().max()) <= limit * 1.0001
    assert torch.equal(init_params(cfg, seed=3, device="cpu").embed,
                       model.embed)


def test_forward_matches_reference(carried):
    case, ref_cfg, params, cfg, model = carried
    toks = _tokens()
    want = ref_forward(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                       remat=False)
    err = _close(forward(model, cfg, {"tokens": _t(toks)}), want, LOGIT_TOL)
    print(f"{case}: forward logits max |d| {err:.3g}")


def test_prefill_matches_reference_logits_and_cache(carried):
    _, ref_cfg, params, cfg, model = carried
    toks = _tokens()[:, :P]
    want, ref_cache = ref_prefill(params, ref_cfg,
                                  {"tokens": jnp.asarray(toks)}, max_len=S,
                                  cache_dtype=jnp.float32)
    logits, cache = prefill(model, cfg, {"tokens": _t(toks)}, S)
    _close(logits, want, LOGIT_TOL)
    assert cache["len"] == int(ref_cache["len"]) == P
    for i in range(cfg.n_layers):
        _close(cache["k"][i], ref_cache["k"][i], CACHE_TOL, f"k {i}")
        _close(cache["v"][i], ref_cache["v"][i], CACHE_TOL, f"v {i}")


def test_decode_steps_match_reference(carried):
    """4 decode steps after a 12-token prefill: each step's logits within
    2e-4 of the reference's step and of the port's own full forward (the
    invariant of tests/test_serving.py)."""
    case, ref_cfg, params, cfg, model = carried
    toks = _tokens(seed=4)
    full = forward(model, cfg, {"tokens": _t(toks)})
    _, ref_cache = ref_prefill(params, ref_cfg,
                               {"tokens": jnp.asarray(toks[:, :P])},
                               max_len=S, cache_dtype=jnp.float32)
    _, cache = prefill(model, cfg, {"tokens": _t(toks[:, :P])}, S)
    errs = []
    for t in range(P, S):
        want, ref_cache = ref_decode_step(
            params, ref_cfg, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            ref_cache)
        got, cache = decode_step(model, cfg, {"tokens": _t(toks[:, t:t + 1])},
                                 cache)
        errs.append(_close(got, want, DECODE_TOL, f"step {t}"))
        _close(got, full[:, t], DECODE_TOL, f"step {t} vs forward")
    assert cache["len"] == S == int(ref_cache["len"])
    for i in range(cfg.n_layers):
        _close(cache["k"][i], ref_cache["k"][i], CACHE_TOL, f"k {i}")
    print(f"{case}: decode step logits max |d| {max(errs):.3g}")


def test_serve_loop_matches_reference_greedy_tokens(carried):
    """The launcher's greedy loop (prefill into a cache of prompt + new
    positions, then ``make_serve_step``) gives the reference's tokens for
    the same prompts and weights (float32 caches on both sides)."""
    _, ref_cfg, params, cfg, model = carried
    prompts = _tokens(seed=5, shape=(B, 8))
    toks, _, _ = serve.generate(model, cfg, _t(prompts).long(), 6)
    logits, cache = ref_prefill(params, ref_cfg,
                                {"tokens": jnp.asarray(prompts)}, max_len=14,
                                cache_dtype=jnp.float32)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    step = jax.jit(ref_make_serve_step(ref_cfg))
    want = [tok]
    for _ in range(5):
        tok, cache = step(params, {"tokens": tok[:, None]}, cache)
        want.append(tok)
    assert toks.tolist() == np.stack(want, axis=1).tolist()


def test_init_cache_is_zero_and_shaped_as_reference(carried):
    _, ref_cfg, _, cfg, _ = carried
    from repro.models import init_cache as ref_init_cache

    ref = ref_init_cache(ref_cfg, B, S, jnp.float32)
    cache = init_cache(cfg, B, S, torch.float32, "cpu")
    assert cache["len"] == 0
    assert len(cache["k"]) == len(cache["v"]) == cfg.n_layers
    for kc, vc in zip(cache["k"], cache["v"]):
        assert tuple(kc.shape) == tuple(vc.shape) == ref["k"].shape[1:]
        assert kc.dtype == torch.float32 and not kc.any() and not vc.any()


def test_cache_dtype_must_be_the_models_and_the_cache_bounded(carried):
    """The cache takes ``cache_dtype`` as the reference's ``prefill``
    does: a bfloat16 cache under float32 weights (the reference's
    default) is taken and decoded over, a dtype K4 does not take is
    refused; the model's dtype by default; the cache is bounded."""
    _, _, _, cfg, model = carried
    toks = _t(_tokens()[:, :P])
    _, cache = prefill(model, cfg, {"tokens": toks}, S, torch.bfloat16)
    assert all(c.dtype == torch.bfloat16 for c in cache["k"] + cache["v"])
    logits, cache = decode_step(model, cfg, {"tokens": toks[:, :1]}, cache)
    assert logits.dtype == torch.float32 and cache["len"] == P + 1
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prefill(model, cfg, {"tokens": toks}, S, torch.float16)
    with pytest.raises(ValueError, match="max_len"):
        prefill(model, cfg, {"tokens": toks}, P - 1)
    _, cache = prefill(model, cfg, {"tokens": toks}, P, torch.float32)
    assert cache["k"][0].dtype == torch.float32
    _, cache = prefill(model, cfg, {"tokens": toks}, P)
    with pytest.raises(ValueError, match="full"):
        decode_step(model, cfg, {"tokens": toks[:, :1]}, cache)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b",
                                  "recurrentgemma-9b"])
def test_bf16_model_refuses_an_f32_cache_as_k4_does(arch):
    """A bfloat16 model over a float32 cache is refused by ``prefill``,
    on the CPU as K4's decode form refuses it on the card, so no cache is
    taken that the first decode step there would refuse; the bfloat16
    cache is taken."""
    cfg = configs.get_config(arch).reduced()
    model = init_params(cfg, dtype=torch.bfloat16, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 q over a bfloat16 cache"):
        prefill(model, cfg, {"tokens": toks}, 8, torch.float32)
    _, cache = prefill(model, cfg, {"tokens": toks}, 8, torch.bfloat16)
    assert all(c.dtype == torch.bfloat16 for c in cache["k"] + cache["v"])


def test_dense_models_need_a_card_unless_cpu_is_asked(monkeypatch, carried):
    """``DenseLM``, ``init_params``, ``init_cache`` and
    ``params_from_numpy`` default to the card and raise without one."""
    _, _, params, cfg, _ = carried
    tree = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: init_params(cfg), lambda: DenseLM(cfg),
                  lambda: init_cache(cfg, B, S),
                  lambda: params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "smollm-135m",
                                  "qwen1.5-0.5b"])
def test_launcher_serves_dense_on_cpu(arch):
    toks = serve.main(["--arch", arch, "--device", "cpu", "--new-tokens",
                       "3", "--prompt-len", "5", "--batch", "2"])
    assert toks.shape == (2, 3)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "qwen2-moe-a2.7b"])
def test_unserved_configs_name_their_slice(arch):
    """Each config the port does not serve yet is refused by the model
    (``NotImplementedError``) and by the launcher (``SystemExit``), with
    the slice that brings it."""
    cfg = configs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="waits for|causal token"):
        init_params(cfg, device="cpu")
    with pytest.raises(SystemExit, match="not served"):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_attention_module_layouts_are_the_references(carried):
    _, ref_cfg, params, cfg, _ = carried
    attn = Attention(cfg, torch.float32, "cpu")
    ref_layer = jax.tree.map(lambda p: p[0], params["blocks"]["attn"])
    assert {n: tuple(p.shape) for n, p in attn.named_parameters()} == \
        {n: leaf.shape for n, leaf in ref_layer.items()}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
