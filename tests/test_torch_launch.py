"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), on the CPU.

Each case runs the reference launcher's ``main`` as a user would (its
default arch, or ``--arch``), keeping the config and the float32 weights
it builds; then the port's ``main`` on the CPU with the same arguments,
keeping its config.  The two configs must be equal field for field: the
same default arch (``smollm-135m``) and the same reduction (4 layers,
d_model 128, 4 heads, d_ff 512, vocab 1024).  Then the port's
``generate``, on the reference's weights carried across and its prompts
(``jax.random.randint`` from key 1), must give the reference launcher's
32 greedy tokens for each of its 4 prompts: both serve float32 weights
over a bfloat16 KV cache (the reference's ``prefill`` default).  Every
token agrees in every case, so no near-tie needs a tolerance.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as ref_serve

from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy

#: the served archs: the default (None), gemma2, and one of each other
#: served family or kind of attention
ARCHS = [None, "gemma2-2b", "starcoder2-3b", "qwen1.5-0.5b",
         "recurrentgemma-9b", "falcon-mamba-7b"]


def _spy(monkeypatch, module, seen: dict):
    """Record the config ``module.main`` builds and the weights it draws."""
    real = module.init_params

    def init_params(cfg, *args, **kwargs):
        seen["cfg"] = cfg
        seen["params"] = real(cfg, *args, **kwargs)
        return seen["params"]

    monkeypatch.setattr(module, "init_params", init_params)


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a or "default")
def test_launcher_serves_the_reference_launchers_tokens(monkeypatch, arch):
    argv = [] if arch is None else ["--arch", arch]
    ref, port = {}, {}
    _spy(monkeypatch, ref_serve, ref)
    want = np.asarray(ref_serve.main(argv))
    _spy(monkeypatch, serve, port)
    got = serve.main(argv + ["--device", "cpu"])
    assert dataclasses.asdict(port["cfg"]) == dataclasses.asdict(ref["cfg"])
    assert port["cfg"].name == f"{arch or 'smollm-135m'}-reduced"
    assert tuple(got.shape) == want.shape == (4, 32)

    cfg = port["cfg"]
    model = params_from_numpy(jax.tree.map(np.asarray, ref["params"]), cfg,
                              device="cpu")
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 16), 0, cfg.vocab_size))
    toks, _, _ = serve.generate(model, cfg, torch.from_numpy(
        prompts.astype(np.int64)), 32)
    assert toks.tolist() == want.tolist()


def test_launcher_reduces_to_head_dim_32_and_serves_bf16_caches():
    """The reference's reduction gives head_dim 32, a head dim K4 is built
    for in both forms, and ``generate`` serves over a bfloat16 cache."""
    from repro_torch.kernels.attention import attention as K4

    for arch in ("smollm-135m", "gemma2-2b", "starcoder2-3b"):
        cfg = serve.config_for(arch, True)
        assert cfg.resolved_head_dim == 32
        assert 32 in K4.HEAD_DIMS and 32 in K4.DECODE_HEAD_DIMS
    assert serve.CACHE_DTYPE == torch.bfloat16
    assert serve.parser().parse_args([]).arch == "smollm-135m"
