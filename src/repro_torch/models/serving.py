"""Serving of the port (``src/repro/models/serving.py``), ssm, dense and
hybrid families: prefill + single-token decode with an explicit cache.

* ssm: the cache holds no keys or values: per layer a ``conv`` history
  (B, cw-1, inner) in the activation dtype and the scan state ``h``
  (B, inner, n) in float32 -- constant memory per sequence.  Prefill runs
  the sequence form from zero states and keeps each layer's final state,
  as the reference's ``_prefill_recurrent`` does; ``decode_step`` runs one
  token from the cached states (``_ssm_decode``).  Both launch K5 once per
  layer.
* dense: per layer a key and a value cache (B, max_len, KV, hd) in the
  cache dtype.  Prefill runs the prompt over itself and writes each
  layer's roped k/v at [0, S); ``decode_step`` writes the new token's k/v
  at ``len`` and attends over the first ``len + 1`` positions
  (``_stacked_decode``), gemma2's local layers over the last
  ``local_window`` of them.  Both launch K4 once per layer.  The caches
  are written in place: the cache a step returns holds the same tensors
  as the one it was given.
* hybrid (RecurrentGemma): per local-attention layer a **ring buffer** of
  the window only, k and v (B, w, KV, hd) with ``w = min(window,
  max_len)`` -- constant memory per sequence -- and per RG-LRU layer a
  ``conv`` history and the float32 state ``h`` (B, W).  Prefill runs the
  sequence form from zero states, attends within the window and fills
  each ring with the prompt's last ``w`` keys in ring order (``pos % w``);
  ``decode_step`` writes the new token's k/v at ``pos % w`` and attends
  over the ``min(pos + 1, w)`` keys the ring holds (``_hybrid_decode``),
  its query roped at the absolute ``pos``.  Both launch K6 once per RG-LRU
  layer and K4 once per attention layer.  The rings are written in place.

Every cache carries ``len``, the tokens consumed, as a Python int.  The
KV caches and rings take ``prefill``'s ``cache_dtype`` (the model's
dtype by default; the reference's launcher serves float32 weights over a
bfloat16 cache, and ``launch/serve.py::generate`` does so too): k and v
are cast into it as they are written, and K4 reads a bfloat16 cache
under a float32 query in its decode form.

The audio family's encoder (HuBERT) has no decode step, in the reference
as here (``cfg.supports_decode`` is False): ``init_cache`` and
``prefill``, which every cache comes from, refuse it and name
``forward``, which encodes.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.attention.attention import cache_dtypes
from .config import ArchConfig
from .recurrent import mamba_init_state, rglru_init_state
from .transformer import require_served

def require_decode(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a config without a decode step (an
    encoder), naming ``forward``; else ``require_served``."""
    if not cfg.supports_decode:
        raise ValueError(
            f"{cfg.name} is encoder-only: it has no cache, prefill or decode "
            f"step; encode with models.forward(model, cfg, "
            f"{{'embeds': x}})")
    require_served(cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zero decode cache on ``device`` (the card unless the caller asks for
    the CPU): ``len`` 0 and, for the ssm family, ``rec``, one
    ``mamba_init_state`` per layer (``max_len`` unused, ``dtype`` the
    conv history's); for the dense family ``k`` and ``v``, one
    (B, max_len, KV, hd) tensor of ``dtype`` per layer; for the hybrid
    family ``k`` and ``v``, one (B, min(window, max_len), KV, hd) ring of
    ``dtype`` per attention layer, and ``rec``, one ``rglru_init_state``
    per RG-LRU layer."""
    require_decode(cfg)
    dev = resolve_device(device)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        return {"len": 0,
                "rec": [mamba_init_state(cfg, batch, dtype, dev)
                        for _ in range(cfg.n_layers)]}
    n_attn = sum(k != "rglru" for k in kinds)
    positions = max_len
    cache: dict = {"len": 0}
    if cfg.family == "hybrid":
        positions = min(cfg.rglru.window, max_len)
        cache["rec"] = [rglru_init_state(cfg, batch, dtype, dev)
                        for k in kinds if k == "rglru"]
    shape = (batch, positions, cfg.n_kv_heads, cfg.resolved_head_dim)
    for name in ("k", "v"):
        cache[name] = [torch.zeros(shape, dtype=dtype, device=dev)
                       for _ in range(n_attn)]
    return cache


@torch.no_grad()
def prefill(params, cfg: ArchConfig, batch: dict, max_len: int,
            cache_dtype=None):
    """batch: tokens (B, S).  Returns (logits (B, S, vocab), cache after
    the S tokens).  Dense: the cache holds ``max_len`` positions in
    ``cache_dtype`` (None: the model's dtype; a bfloat16 cache under a
    float32 model too, as K4's decode form takes: ``cache_dtypes``), the
    prompt attending over its own k/v before they are cast into the
    cache, as the reference's ``prefill`` does.  Hybrid: the rings hold
    ``min(window, max_len)`` positions in ``cache_dtype`` (the same rule);
    the RG-LRU states are the sequence form's final states, as the
    reference's ``_prefill_recurrent`` returns them.  Ssm: ``max_len`` and
    ``cache_dtype`` are unused; the states take the model's dtype, as the
    reference's ``_prefill_recurrent`` returns them."""
    require_decode(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.family == "ssm":
        cache = init_cache(cfg, b, max_len, params.dtype, tokens.device)
        logits, rec = params.run(tokens, cache["rec"])
        return logits, {"len": s, "rec": rec}
    cache_dtype = params.dtype if cache_dtype is None else cache_dtype
    if cache_dtype not in cache_dtypes(params.dtype):
        raise ValueError(f"a {params.dtype} model's KV cache takes "
                         f"{cache_dtypes(params.dtype)} (K4's decode form: a "
                         f"float32 or bfloat16 q over a cache of its dtype, "
                         f"or a float32 q over a bfloat16 cache), not "
                         f"{cache_dtype}")
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, cache_dtype, tokens.device)
    if cfg.family == "hybrid":
        logits, rec = params.run(tokens, (cache["k"], cache["v"]))
        return logits, dict(cache, rec=rec, len=s)
    logits = params.run(tokens, (cache["k"], cache["v"]))
    return logits, dict(cache, len=s)


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, batch: dict, cache: dict):
    """batch: tokens (B, 1).  Returns (logits (B, vocab), updated cache)."""
    pos = cache["len"]
    if cfg.family == "ssm":
        logits, rec = params.run(batch["tokens"], cache["rec"])
        return logits[:, 0], {"len": pos + 1, "rec": rec}
    if cfg.family == "hybrid":
        logits, rec = params.step(batch["tokens"], (cache["k"], cache["v"]),
                                  cache["rec"], pos)
        return logits[:, 0], dict(cache, rec=rec, len=pos + 1)
    logits = params.step(batch["tokens"], (cache["k"], cache["v"]), pos)
    return logits[:, 0], dict(cache, len=pos + 1)
