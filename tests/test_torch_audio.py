"""Port LM, audio family (HuBERT-XLarge's encoder), and K4's non-causal
plain version, against the JAX reference, on the CPU.

The reference's weights (``repro.models.init_params``, whose frames
frontend has no embedding) cross over as numpy arrays through
``repro_torch.models.convert.params_from_numpy``.  The norms, which the
reference initialises to zero, are first set to random values from numpy
in the one tree both packages use, so that the ``1 + weight`` scaling is
held too.  Frame embeddings are made from seeds with numpy.  The port runs
its plain path here (K4's plain version); the CUDA kernel is held against
that plain version by ``tests/test_torch_kernels.py`` (marked ``cuda``)
and by ``chip_smoke.py``.

Configs: ``hubert-xlarge`` reduced as ``tests/test_serving.py`` reduces
configs (2 layers, d 64, 4 heads over 4, head_dim 16, GeLU d_ff 128), and
a reduced copy at HuBERT's own head_dim 80 (d 160, 2 heads over 2), the
head dim the CUDA kernel takes for this family.

Tolerances, stated up front (float32 throughout; the two sides sum the
matrix products and the softmax in different orders):
* logits of ``forward``: 1e-4 of the largest |logit|, the bound
  ``tests/test_serving.py`` holds the reference to itself at;
* K4's non-causal plain version vs the reference's Pallas kernel
  (interpret mode) and its jnp oracle: 2e-5, the bound of
  ``tests/test_kernels.py``;
* the non-causal output of query row 0 against the causal one: apart by
  more than ``ref.HOLD``, so the mask acts.
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
from repro.launch import serve as ref_serve
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params

from repro_torch import configs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref, hold_ratio
from repro_torch.launch import serve
from repro_torch.models import (DenseLM, forward, init_cache, init_params,
                                prefill)
from repro_torch.models.convert import params_from_numpy

B, S = 2, 40
LOGIT_TOL = 1e-4  # of the largest |logit|
KERNEL_TOL = 2e-5

#: case -> extra ``reduced`` arguments
CASES = {"hubert-xlarge": {}, "hubert-xlarge-hd80": {"d_model": 160,
                                                    "n_heads": 2}}


def _t(x):
    return torch.from_numpy(np.array(x))


def _embeds(d, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).normal(0, 1, (*shape, d)).astype(
        np.float32)


def _randomise_norms(tree: dict, seed: int) -> dict:
    """The tree with ``ln_f``, ``blocks/ln1`` and ``blocks/ln2`` drawn
    from numpy instead of the reference's zeros."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        return rng.normal(0, 0.2, leaf.shape).astype(leaf.dtype)

    blocks = dict(tree["blocks"], ln1=draw(tree["blocks"]["ln1"]),
                  ln2=draw(tree["blocks"]["ln2"]))
    return dict(tree, ln_f=draw(tree["ln_f"]), blocks=blocks)


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    """(case, reference cfg, reference params, port cfg, port model): the
    reference's float32 weights, with random norms, in both."""
    extra = CASES[request.param]
    ref_cfg = ref_configs.get_config("hubert-xlarge").reduced(**extra)
    cfg = configs.get_config("hubert-xlarge").reduced(**extra)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = _randomise_norms(jax.tree.map(np.asarray, params),
                            seed=len(request.param))
    return (request.param, ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, device="cpu"))


def test_cases_are_the_audio_encoder_at_head_dims_16_and_80(carried):
    case, ref_cfg, params, cfg, model = carried
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert (cfg.family, cfg.frontend, cfg.causal, cfg.supports_decode) == \
        ("audio", "frames", False, False)
    assert cfg.resolved_head_dim == (80 if case.endswith("hd80") else 16)
    assert cfg.n_kv_heads == cfg.n_heads and not cfg.tie_embeddings
    assert "embed" not in params and isinstance(model, DenseLM)
    assert not hasattr(model, "embed")


def test_carried_weights_keep_shapes_and_values(carried):
    _, _, params, cfg, model = carried
    blocks = params["blocks"]
    assert len(model.blocks) == cfg.n_layers == blocks["ln1"].shape[0]
    for i, block in enumerate(model.blocks):
        assert block.causal is False and block.window == 0
        for group in ("attn", "mlp"):
            for name, leaf in blocks[group].items():
                assert np.array_equal(
                    getattr(getattr(block, group), name).numpy(),
                    np.asarray(leaf[i])), (group, name)
        assert bool(block.ln1.any()) and bool(block.ln2.any())
    assert np.array_equal(model.lm_head.numpy(), np.asarray(params["lm_head"]))
    assert model.dtype == torch.float32


def test_init_params_draws_the_reference_shapes(carried):
    """The port's own init gives every leaf the reference's shape, no
    embedding, norms zero, and the same weights for the same seed."""
    _, _, params, cfg, _ = carried
    model = init_params(cfg, seed=3, device="cpu")
    assert isinstance(model, DenseLM)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()
            if not n.startswith("blocks")} == \
        {n: leaf.shape for n, leaf in params.items() if n != "blocks"}
    for group in ("attn", "mlp"):
        for name, leaf in params["blocks"][group].items():
            assert tuple(getattr(getattr(model.blocks[0], group),
                                 name).shape) == leaf.shape[1:], name
    assert not model.ln_f.any() and not model.blocks[0].ln1.any()
    assert torch.equal(init_params(cfg, seed=3, device="cpu").lm_head,
                       model.lm_head)


def test_forward_matches_reference(carried):
    """Frame embeddings (B, 40, d) through the encoder: the port's logits
    within 1e-4 of the largest |logit| of ``repro.models.forward``."""
    case, ref_cfg, params, cfg, model = carried
    x = _embeds(cfg.d_model)
    want = np.asarray(ref_forward(params, ref_cfg, {"embeds": jnp.asarray(x)},
                                  remat=False))
    got = forward(model, cfg, {"embeds": _t(x)})
    assert tuple(got.shape) == want.shape == (B, S, cfg.vocab_size)
    err = float(np.max(np.abs(got.numpy().astype(np.float64) - want)))
    scale = float(np.max(np.abs(want)))
    print(f"{case}: forward logits max |d| {err:.3g}, {err / scale:.3g} of "
          f"the largest |logit| {scale:.3g}")
    assert err <= LOGIT_TOL * scale


def test_forward_attends_both_ways(carried):
    """Changing the last frame changes the first frame's logits: the
    encoder's attention is bidirectional (a causal one would leave them
    bit for bit)."""
    _, _, _, cfg, model = carried
    x = _embeds(cfg.d_model, seed=1)
    y = x.copy()
    y[:, -1] += 1.0
    a = forward(model, cfg, {"embeds": _t(x)})
    b = forward(model, cfg, {"embeds": _t(y)})
    assert not torch.equal(a[:, 0], b[:, 0])


def test_forward_refuses_embeds_of_another_dtype(carried):
    """Embeddings that are not floating point, or not (B, S, d), are
    refused; floating ones of another dtype than the weights are promoted
    with them, as the reference's products promote them (bfloat16 frames
    over float32 weights run in float32)."""
    _, _, _, cfg, model = carried
    x = _t(_embeds(cfg.d_model))
    with pytest.raises(ValueError, match="floating point"):
        forward(model, cfg, {"embeds": x.to(torch.int32)})
    with pytest.raises(ValueError, match="embeds must be"):
        forward(model, cfg, {"embeds": x[..., :-1]})
    got = forward(model, cfg, {"embeds": x.to(torch.bfloat16)})
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())


def test_f32_frames_over_bf16_weights_match_the_references_promotion():
    """Float32 frame embeddings over bfloat16 weights: the reference's
    ``x @ wq`` promotes to float32, and so does the port
    (``layers.matmul``), so the two encoders agree to float32 rounding:
    within 1e-4 of the largest |logit|, the logits float32."""
    ref_cfg = ref_configs.get_config("hubert-xlarge").reduced()
    cfg = configs.get_config("hubert-xlarge").reduced()
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tree = _randomise_norms(jax.tree.map(np.asarray, params), seed=3)
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    x = _embeds(cfg.d_model, seed=2)
    want = np.asarray(ref_forward(jax.tree.map(jnp.asarray, tree), ref_cfg,
                                  {"embeds": jnp.asarray(x)}, remat=False))
    got = forward(model, cfg, {"embeds": _t(x)})
    assert want.dtype == np.float32 and got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy().astype(np.float64) - want)))
    scale = float(np.max(np.abs(want)))
    print(f"f32 frames over bf16 weights: logits max |d| {err:.3g}, "
          f"{err / scale:.3g} of the largest |logit| {scale:.3g}")
    assert err <= LOGIT_TOL * scale


# ---------------------------------------------------------------------------
# K4's non-causal plain version

def _qkv(b, h, kvh, s, hd, seed):
    """q (b, s, h, hd), k, v (b, s, kvh, hd) float32 from numpy, the same
    arrays for both packages."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


@pytest.mark.parametrize("s", [99, 130])
@pytest.mark.parametrize("grouped", [False, True])
def test_noncausal_plain_attention_matches_reference_kernel(s, grouped):
    """The non-causal plain version at head_dim 80, KV heads not repeated,
    against the Pallas kernel (interpret mode, 64-row blocks: 99 and 130
    are multiples of no tile, so the last key block is ragged and its
    padded keys must be masked) on the repeated (B, H, S, hd) layout, and
    against the reference's jnp oracle through its ``gqa_attention``."""
    h, kvh = (4, 2) if grouped else (2, 2)
    q, k, v = _qkv(2, h, kvh, s, 80, seed=s + h)
    got = attention_ref(_t(q), _t(k), _t(v), causal=False)
    rep = h // kvh
    tr = (0, 2, 1, 3)
    kern = ref_kernel(jnp.asarray(q).transpose(tr),
                      jnp.repeat(jnp.asarray(k).transpose(tr), rep, axis=1),
                      jnp.repeat(jnp.asarray(v).transpose(tr), rep, axis=1),
                      causal=False, q_block=64, k_block=64, interpret=True)
    oracle = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, use_pallas=False)
    for want, what in ((np.asarray(kern).transpose(tr), "kernel"),
                       (np.asarray(oracle), "oracle")):
        err = float(np.max(np.abs(got.numpy() - want)))
        assert err <= KERNEL_TOL, (what, err)
    assert torch.equal(
        attn_ops.gqa_attention(_t(q), _t(k), _t(v), causal=False), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_row_zero_differs_from_causal(dtype):
    """Query row 0 sees key 0 alone under the causal mask and every key
    without it: the two outputs lie apart by more than ``ref.HOLD``
    allows, so a kernel that kept the causal mask fails the hold."""
    q, k, v = (_t(a).to(dtype) for a in _qkv(2, 4, 4, 65, 80, seed=7))
    full = attention_ref(q, k, v, causal=False)
    causal = attention_ref(q, k, v)
    assert torch.equal(causal[:, 0], v[:, 0])
    assert hold_ratio(causal[:, :1], full[:, :1]) > 1
    # the last row sees every key under both masks
    torch.testing.assert_close(causal[:, -1], full[:, -1], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# no decode step: refused by the launcher and by serving, as the reference

def test_hubert_builds_and_launcher_refuses():
    """The audio encoder builds (it was refused before its slice), and the
    launcher still refuses it with the reference launcher's own message,
    before anything else."""
    cfg = configs.get_config("hubert-xlarge").reduced()
    assert isinstance(init_params(cfg, device="cpu"), DenseLM)
    with pytest.raises(SystemExit) as ref_exit:
        ref_serve.main(["--arch", "hubert-xlarge"])
    with pytest.raises(SystemExit) as port_exit:
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value) == \
        "hubert-xlarge is encoder-only: no decode step"


def test_serving_refuses_the_encoder_and_names_forward(carried):
    _, _, _, cfg, model = carried
    x = _t(_embeds(cfg.d_model))
    with pytest.raises(ValueError, match="encoder-only.*forward"):
        init_cache(cfg, B, S, torch.float32, "cpu")
    with pytest.raises(ValueError, match="encoder-only.*forward"):
        prefill(model, cfg, {"embeds": x}, S)


def test_audio_model_needs_a_card_unless_cpu_is_asked(monkeypatch, carried):
    _, _, params, cfg, _ = carried
    tree = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: init_params(cfg), lambda: DenseLM(cfg),
                  lambda: params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_vlm_is_still_refused_with_its_own_message():
    cfg = configs.get_config("qwen2-vl-72b").reduced()
    with pytest.raises(NotImplementedError, match="vlm family's slice"):
        init_params(cfg, device="cpu")
