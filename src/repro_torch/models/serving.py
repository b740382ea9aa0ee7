"""Serving of the port (``src/repro/models/serving.py``), ssm and dense
families: prefill + single-token decode with an explicit cache.

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
  (``_stacked_decode``).  Both launch K4 once per layer.  The caches are
  written in place: the cache a step returns holds the same tensors as
  the one it was given.

Both caches carry ``len``, the tokens consumed, as a Python int.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .config import ArchConfig
from .recurrent import mamba_init_state
from .transformer import require_served


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zero decode cache on ``device`` (the card unless the caller asks for
    the CPU): ``len`` 0 and, for the ssm family, ``rec``, one
    ``mamba_init_state`` per layer (``max_len`` unused, ``dtype`` the
    conv history's); for the dense family ``k`` and ``v``, one
    (B, max_len, KV, hd) tensor of ``dtype`` per layer."""
    require_served(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return {"len": 0,
                "rec": [mamba_init_state(cfg, batch, dtype, dev)
                        for _ in range(cfg.n_layers)]}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"len": 0,
            "k": [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(cfg.n_layers)]}


@torch.no_grad()
def prefill(params, cfg: ArchConfig, batch: dict, max_len: int,
            cache_dtype=None):
    """batch: tokens (B, S).  Returns (logits (B, S, vocab), cache after
    the S tokens).  Dense: the cache holds ``max_len`` positions in the
    model's dtype (K4 takes q, k and v of one dtype); ``cache_dtype``, the
    reference's argument, may only name that dtype.  Ssm: ``max_len`` and
    ``cache_dtype`` are unused; the states take the model's dtype, as the
    reference's ``_prefill_recurrent`` returns them."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.family == "ssm":
        cache = init_cache(cfg, b, max_len, params.dtype, tokens.device)
        logits, rec = params.run(tokens, cache["rec"])
        return logits, {"len": s, "rec": rec}
    if cache_dtype not in (None, params.dtype):
        raise ValueError(f"the KV cache must take the model's dtype "
                         f"({params.dtype}), not {cache_dtype}")
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, params.dtype, tokens.device)
    logits = params.run(tokens, (cache["k"], cache["v"]))
    return logits, dict(cache, len=s)


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, batch: dict, cache: dict):
    """batch: tokens (B, 1).  Returns (logits (B, vocab), updated cache)."""
    pos = cache["len"]
    if cfg.family == "ssm":
        logits, rec = params.run(batch["tokens"], cache["rec"])
        return logits[:, 0], {"len": pos + 1, "rec": rec}
    logits = params.step(batch["tokens"], (cache["k"], cache["v"]), pos)
    return logits[:, 0], dict(cache, len=pos + 1)
