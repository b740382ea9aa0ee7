"""Weights carried across from the reference: a ``repro.models``
parameter tree, as numpy arrays, into the port's ``MambaLM`` or
``DenseLM``.

The tree is what ``repro.models.init_params`` returns, converted leaf by
leaf with ``numpy.asarray``: ``embed``, ``ln_f``, ``lm_head`` (untied
only) and ``blocks``, whose leaves carry the layers on axis 0.
* ssm: ``blocks/ln1`` (L, d) and ``blocks/ssm/{in_proj, ...}``.
  ``blocks/ln2`` is dropped: the reference initialises it for every family
  but the ssm family has no FFN and never reads it.
* dense: ``blocks/ln1``, ``blocks/ln2`` (L, d),
  ``blocks/attn/{wq, wk, wv, wo}`` and, with qkv bias, ``{bq, bk, bv}``,
  and ``blocks/mlp/{wi, wo}`` plus ``wg`` for the gated MLP.
Layouts are the same on both sides, so each leaf is copied as it is;
bfloat16 leaves (``ml_dtypes``) are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig
from .transformer import DenseLM, MambaLM

_SSM_LEAVES = ("in_proj", "conv", "x_proj", "dt_proj", "dt_bias", "a_log",
               "d", "out_proj")
_ATTN_LEAVES = ("wq", "wk", "wv", "wo")
_BIAS_LEAVES = ("bq", "bk", "bv")


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _copy(dst: torch.nn.Parameter, src, name: str) -> None:
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
        raise ValueError(f"{name}: reference leaf {tuple(t.shape)} {t.dtype} "
                         f"does not fit {tuple(dst.shape)} {dst.dtype}")
    with torch.no_grad():
        dst.copy_(t)


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None):
    """A ``MambaLM`` (ssm) or ``DenseLM`` (dense) on ``device`` (the card
    unless the caller asks for the CPU) holding the reference tree's
    weights, in the tree's projection dtype."""
    dtype = _tensor(tree["embed"]).dtype
    dev = resolve_device(device)
    model = (MambaLM if cfg.family == "ssm" else DenseLM)(cfg, dtype, dev)
    heads = ("embed", "ln_f") + (() if cfg.tie_embeddings else ("lm_head",))
    for name in heads:
        _copy(getattr(model, name), tree[name], name)
    blocks = tree["blocks"]
    for i, block in enumerate(model.blocks):
        _copy(block.ln1, blocks["ln1"][i], f"blocks/ln1[{i}]")
        if cfg.family == "ssm":
            for name in _SSM_LEAVES:
                _copy(getattr(block.ssm, name), blocks["ssm"][name][i],
                      f"blocks/ssm/{name}[{i}]")
            continue
        _copy(block.ln2, blocks["ln2"][i], f"blocks/ln2[{i}]")
        for name in _ATTN_LEAVES + (_BIAS_LEAVES if cfg.qkv_bias else ()):
            _copy(getattr(block.attn, name), blocks["attn"][name][i],
                  f"blocks/attn/{name}[{i}]")
        for name in ("wi", "wo") + (("wg",) if cfg.act == "silu" else ()):
            _copy(getattr(block.mlp, name), blocks["mlp"][name][i],
                  f"blocks/mlp/{name}[{i}]")
    return model
