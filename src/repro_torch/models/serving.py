"""Serving of the port (``src/repro/models/serving.py``), ssm family:
prefill + single-token decode with an explicit recurrent cache.

The ssm cache holds no keys or values: per layer a ``conv`` history
(B, cw-1, inner) in the activation dtype and the scan state ``h``
(B, inner, n) in float32 -- constant memory per sequence -- plus ``len``,
the tokens consumed.  Prefill runs the sequence form from ``init_cache``'s
zero states and keeps each layer's final state, as the reference's
``_prefill_recurrent`` does; ``decode_step`` runs one token from the
cached states (``_ssm_decode``).  Both launch K5 once per layer.
"""

from __future__ import annotations

import torch

from .config import ArchConfig
from .recurrent import mamba_init_state
from .transformer import MambaLM, _require_ssm


def init_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """Zero decode cache: ``rec``, one ``mamba_init_state`` per layer, and
    ``len`` 0."""
    _require_ssm(cfg)
    return {"len": 0,
            "rec": [mamba_init_state(cfg, batch, dtype, device)
                    for _ in range(cfg.n_layers)]}


@torch.no_grad()
def prefill(params: MambaLM, cfg: ArchConfig, batch: dict):
    """batch: tokens (B, S).  Returns (logits (B, S, vocab), cache after
    the S tokens)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, params.dtype, tokens.device)
    logits, rec = params.run(tokens, cache["rec"])
    return logits, {"len": s, "rec": rec}


@torch.no_grad()
def decode_step(params: MambaLM, cfg: ArchConfig, batch: dict, cache: dict):
    """batch: tokens (B, 1).  Returns (logits (B, vocab), updated cache)."""
    logits, rec = params.run(batch["tokens"], cache["rec"])
    return logits[:, 0], {"len": cache["len"] + 1, "rec": rec}
