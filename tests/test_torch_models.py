"""Port LM (ssm family: Falcon-Mamba) vs the JAX reference, on the CPU.

The reference's weights (``repro.models.init_params``) cross over as numpy
arrays through ``repro_torch.models.convert.params_from_numpy``, so both
packages compute with the same float32 weights; inputs are made from seeds
with numpy.  The port runs its plain path here (K5's plain scan); the CUDA
kernel is held against that plain scan by ``tests/test_torch_kernels.py``
(marked ``cuda``) and by ``chip_smoke.py``.

Tolerances, stated up front (float32 throughout; the two sides sum
matrix products and the scan's contraction in different orders):
* the port's plain scan vs the reference's Pallas kernel (interpret mode)
  and its jnp oracle: 1e-5 absolute and relative;
* ``MambaMixer`` vs ``mamba_mix`` (``step`` and ``chunk``): 1e-5;
* logits of ``forward``, ``prefill`` and each ``decode_step``: 1e-4
  absolute, as ``tests/test_serving.py`` holds the reference to itself;
* cache: ``conv`` equal to 1e-6, ``h`` to 1e-5, ``len`` equal;
* greedy tokens of the serve loop: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs
from repro.kernels.mamba_scan.mamba_scan import mamba_scan as ref_kernel_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref as ref_oracle_scan
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import recurrent as ref_recurrent
from repro.models.layers import rms_norm as ref_rms_norm
from repro.train import make_serve_step as ref_make_serve_step

from repro_torch import configs
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import rms_norm
from repro_torch.models.recurrent import _causal_conv

ARCH = "falcon-mamba-7b"
B, S, P = 2, 16, 12  # as tests/test_serving.py
LOGIT_TOL = 1e-4


def _cfgs():
    return ref_configs.get_config(ARCH).reduced(), \
        configs.get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, reference params, port cfg, port model) with the
    reference's float32 weights carried across."""
    ref_cfg, cfg = _cfgs()
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return ref_cfg, params, cfg, params_from_numpy(tree, cfg, device="cpu")


def _tokens(seed=0, shape=(B, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    err = float(np.max(np.abs(got.astype(np.float64)
                              - np.asarray(want, np.float64))))
    assert got.shape == np.asarray(want).shape, what
    assert err <= tol, (what, err)
    return err


# ---------------------------------------------------------------------------
# configuration (pure data, copied)

@pytest.mark.parametrize("arch", sorted(ref_configs.ARCHS))
def test_config_copy_matches_reference(arch):
    ref, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == \
        [ref.layer_kind(i) for i in range(ref.n_layers)]


def test_other_families_wait_for_their_slice():
    gemma2 = init_params(configs.get_config("gemma2-2b").reduced(),
                         device="cpu")
    assert type(gemma2).__name__ == "DenseLM"
    hybrid = init_params(configs.get_config("recurrentgemma-9b").reduced(),
                         device="cpu")
    assert type(hybrid).__name__ == "HybridLM"
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu"])


def test_models_need_a_card_unless_cpu_is_asked(monkeypatch, carried):
    """``init_params``, ``MambaLM`` and ``params_from_numpy`` default to the
    card and raise without one; none builds on the CPU unasked."""
    from repro_torch.models.transformer import MambaLM

    ref_cfg, params, cfg, _ = carried
    tree = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: init_params(cfg), lambda: MambaLM(cfg),
                  lambda: params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


# ---------------------------------------------------------------------------
# layers

def test_rms_norm_and_causal_conv_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (B, 5, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, 64).astype(np.float32)
    _close(rms_norm(_t(x), _t(w)), ref_rms_norm(jnp.asarray(x), w), 1e-6)
    cw = rng.normal(0, 0.5, (4, 64)).astype(np.float32)
    state = rng.normal(0, 1, (B, 3, 64)).astype(np.float32)
    for st in (None, state):
        y, new = _causal_conv(_t(x), _t(cw), None if st is None else _t(st))
        ry, rnew = ref_recurrent._causal_conv(
            jnp.asarray(x), jnp.asarray(cw),
            None if st is None else jnp.asarray(st))
        _close(y, ry, 1e-6)
        _close(new, rnew, 0.0)


# ---------------------------------------------------------------------------
# K5's plain version vs the reference kernel and its oracle

def _scan_inputs(bsz, s, inner, n, seed):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(-2, 1, (bsz, s, inner)))
                     ).astype(np.float32)
    xc = rng.normal(0, 1, (bsz, s, inner)).astype(np.float32)
    b = rng.normal(0, 1, (bsz, s, n)).astype(np.float32)
    c = rng.normal(0, 1, (bsz, s, n)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (inner, 1))
    return delta, xc, b, c, a


@pytest.mark.parametrize("bsz,s,inner,n", [(2, 20, 40, 8), (1, 7, 24, 16),
                                           (2, 1, 16, 8)])
def test_plain_scan_matches_reference_kernel_and_oracle(bsz, s, inner, n):
    """With ``da = exp(delta·a)`` and ``dbx = delta·xc·b`` formed in numpy
    and a zero initial state, the port's plain scan gives the reference
    Pallas kernel's (interpret mode) and the jnp oracle's y and final
    state."""
    delta, xc, b, c, a = _scan_inputs(bsz, s, inner, n, seed=s)
    da = np.exp(delta[..., None] * a)
    dbx = (delta * xc)[..., None] * b[:, :, None, :]
    y, h = mamba_scan_ref(_t(delta), _t(xc), _t(b), _t(c), _t(a))
    ky, kh = ref_kernel_scan(jnp.asarray(da), jnp.asarray(dbx),
                             jnp.asarray(c), interpret=True)
    oy, oh = ref_oracle_scan(jnp.asarray(da), jnp.asarray(dbx),
                             jnp.asarray(c))
    for want_y, want_h in ((ky, kh), (oy, oh)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5,
                                   atol=1e-5)
    # ops routes a CPU tensor to the plain version
    y2, h2 = scan_ops.selective_scan(_t(delta), _t(xc), _t(b), _t(c), _t(a))
    assert torch.equal(y2, y) and torch.equal(h2, h)


# ---------------------------------------------------------------------------
# the Mamba mixer

def _mixer_inputs(cfg, with_state, seed=2, s=9):
    rng = np.random.default_rng(seed)
    inner = cfg.ssm.expand * cfg.d_model
    x = rng.normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)
    if not with_state:
        return x, None
    state = {"conv": rng.normal(0, 1, (B, cfg.ssm.conv_width - 1, inner))
             .astype(np.float32),
             "h": rng.normal(0, 1, (B, inner, cfg.ssm.state_dim))
             .astype(np.float32)}
    return x, state


@pytest.mark.parametrize("scan_impl", ["step", "chunk"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mixer_matches_mamba_mix(carried, scan_impl, with_state):
    ref_cfg, params, cfg, model = carried
    x, state = _mixer_inputs(cfg, with_state)
    layer = jax.tree.map(lambda p: p[1], params["blocks"]["ssm"])
    ref_out, ref_st = ref_recurrent.mamba_mix(
        layer, jnp.asarray(x), ref_cfg,
        None if state is None else jax.tree.map(jnp.asarray, state),
        scan_impl=scan_impl)
    out, st = model.blocks[1].ssm(
        _t(x), None if state is None else {k: _t(v) for k, v in state.items()})
    _close(out, ref_out, 1e-5, "out")
    _close(st["conv"], ref_st["conv"], 1e-6, "conv")
    _close(st["h"], ref_st["h"], 1e-5, "h")


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, serve

def test_carried_weights_keep_shapes_and_drop_ln2(carried):
    _, params, cfg, model = carried
    blocks = params["blocks"]
    assert model.embed.shape == params["embed"].shape
    assert model.lm_head.shape == params["lm_head"].shape
    assert len(model.blocks) == cfg.n_layers == blocks["ln1"].shape[0]
    for name, leaf in blocks["ssm"].items():
        assert tuple(getattr(model.blocks[0].ssm, name).shape) == \
            leaf.shape[1:], name
    assert not any("ln2" in n for n, _ in model.named_parameters())


def test_init_params_draws_the_reference_shapes_and_fixed_leaves(carried):
    """The port's own init (a torch.Generator) gives every leaf the
    reference's shape, the fixed leaves (``a_log``, ``d``, the norms) the
    reference's values, and ``dt_bias`` the softplus inverse of
    a step in [1e-3, 1e-1]."""
    _, params, cfg, _ = carried
    model = init_params(cfg, seed=3, device="cpu")
    ssm = model.blocks[0].ssm
    ref_ssm = jax.tree.map(lambda p: np.asarray(p[0]), params["blocks"]["ssm"])
    for name, leaf in ref_ssm.items():
        assert tuple(getattr(ssm, name).shape) == leaf.shape, name
    _close(ssm.a_log, ref_ssm["a_log"], 1e-6)  # log(1..n), to an ulp
    assert torch.equal(ssm.d, _t(ref_ssm["d"]))
    assert not model.ln_f.any() and not model.blocks[0].ln1.any()
    step = torch.nn.functional.softplus(ssm.dt_bias)
    assert bool(((step >= 1e-3 * 0.999) & (step <= 1e-1 * 1.001)).all())
    assert float(model.embed.abs().max()) <= 2.0
    assert torch.equal(init_params(cfg, seed=3, device="cpu").embed,
                       model.embed)


def test_forward_matches_reference(carried):
    ref_cfg, params, cfg, model = carried
    toks = _tokens()
    want = ref_forward(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                       remat=False)
    _close(forward(model, cfg, {"tokens": _t(toks)}), want, LOGIT_TOL)


def test_prefill_matches_reference_logits_and_cache(carried):
    ref_cfg, params, cfg, model = carried
    toks = _tokens()[:, :P]
    want, ref_cache = ref_prefill(params, ref_cfg,
                                  {"tokens": jnp.asarray(toks)}, max_len=S,
                                  cache_dtype=jnp.float32)
    logits, cache = prefill(model, cfg, {"tokens": _t(toks)}, S)
    _close(logits, want, LOGIT_TOL)
    assert cache["len"] == int(ref_cache["len"]) == P
    for i, st in enumerate(cache["rec"]):
        _close(st["conv"], ref_cache["rec"]["conv"][i], 1e-6, f"conv {i}")
        _close(st["h"], ref_cache["rec"]["h"][i], 1e-5, f"h {i}")


def test_decode_steps_match_reference(carried):
    """4 decode steps after a 12-token prefill: each step's logits within
    1e-4 of the reference's step and of the port's own full forward (the
    invariant of tests/test_serving.py)."""
    ref_cfg, params, cfg, model = carried
    toks = _tokens(seed=4)
    full = forward(model, cfg, {"tokens": _t(toks)})
    _, ref_cache = ref_prefill(params, ref_cfg,
                               {"tokens": jnp.asarray(toks[:, :P])},
                               max_len=S, cache_dtype=jnp.float32)
    _, cache = prefill(model, cfg, {"tokens": _t(toks[:, :P])}, S)
    for t in range(P, S):
        want, ref_cache = ref_decode_step(
            params, ref_cfg, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            ref_cache)
        got, cache = decode_step(model, cfg, {"tokens": _t(toks[:, t:t + 1])},
                                 cache)
        _close(got, want, LOGIT_TOL, f"step {t}")
        _close(got, full[:, t], LOGIT_TOL, f"step {t} vs forward")
    assert cache["len"] == S == int(ref_cache["len"])


def test_serve_loop_matches_reference_greedy_tokens(carried):
    """The launcher's greedy loop (prefill, then ``make_serve_step``)
    gives the reference's tokens for the same prompts and weights."""
    ref_cfg, params, cfg, model = carried
    prompts = _tokens(seed=5, shape=(B, 8))
    toks, _, _ = serve.generate(model, cfg, _t(prompts).long(), 6)
    logits, cache = ref_prefill(params, ref_cfg,
                                {"tokens": jnp.asarray(prompts)}, max_len=14)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    step = jax.jit(ref_make_serve_step(ref_cfg))
    want = [tok]
    for _ in range(5):
        tok, cache = step(params, {"tokens": tok[:, None]}, cache)
        want.append(tok)
    assert toks.tolist() == np.stack(want, axis=1).tolist()


def test_init_cache_is_zero_and_shaped_as_reference(carried):
    _, _, cfg, _ = carried
    cache = init_cache(cfg, B, S, torch.float32, "cpu")
    inner = cfg.ssm.expand * cfg.d_model
    assert cache["len"] == 0 and len(cache["rec"]) == cfg.n_layers
    for st in cache["rec"]:
        assert st["conv"].shape == (B, cfg.ssm.conv_width - 1, inner)
        assert st["h"].shape == (B, inner, cfg.ssm.state_dim)
        assert st["h"].dtype == torch.float32
        assert not st["conv"].any() and not st["h"].any()


def test_launcher_runs_on_cpu():
    toks = serve.main(["--device", "cpu", "--new-tokens", "3",
                       "--prompt-len", "5", "--batch", "2"])
    assert toks.shape == (2, 3)
