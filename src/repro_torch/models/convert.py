"""Weights carried across from the reference: a ``repro.models``
parameter tree, as numpy arrays, into the port's ``MambaLM``,
``DenseLM`` or ``HybridLM``.

The tree is what ``repro.models.init_params`` returns, converted leaf by
leaf with ``numpy.asarray``: ``embed`` (token models only), ``ln_f``,
``lm_head`` (untied only) and ``blocks``, whose leaves carry the layers
on axis 0.
* ssm: ``blocks/ln1`` (L, d) and ``blocks/ssm/{in_proj, ...}``.
  ``blocks/ln2`` is dropped: the reference initialises it for every family
  but the ssm family has no FFN and never reads it.
* dense: ``blocks/ln1``, ``blocks/ln2`` (L, d), with gemma2's post-norms
  ``blocks/pn1``, ``blocks/pn2`` (L, d), ``blocks/attn/{wq, wk, wv, wo}``
  and, with qkv bias, ``{bq, bk, bv}``, and ``blocks/mlp/{wi, wo}`` plus
  ``wg`` for the gated MLP.
* hybrid: two stacked groups, ``blocks/rglru`` (one entry per RG-LRU
  layer: ``ln1``, ``ln2``, ``rglru/{wx, wy, conv, w_input_gate,
  w_rec_gate, a_param, wo}``, ``mlp/{wi, wg, wo}``) and ``blocks/attn``
  (one per local-attention layer, the dense leaves).
* audio (``frontend == "frames"``): no ``embed``; the dense leaves, with
  the untied ``lm_head``.
Layouts are the same on both sides, so each leaf is copied as it is;
bfloat16 leaves (``ml_dtypes``) are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig
from .layers import GATED
from .transformer import MODELS

_SSM_LEAVES = ("in_proj", "conv", "x_proj", "dt_proj", "dt_bias", "a_log",
               "d", "out_proj")
_ATTN_LEAVES = ("wq", "wk", "wv", "wo")
_BIAS_LEAVES = ("bq", "bk", "bv")
_RGLRU_LEAVES = ("wx", "wy", "conv", "w_input_gate", "w_rec_gate", "a_param",
                 "wo")


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


def _copy_blocks(modules, blocks: dict, mixer: str, cfg: ArchConfig,
                 path: str) -> None:
    """Copy a stacked group of the reference's blocks (leaves carrying the
    layers on axis 0) into the port's blocks, one per layer: ``ln1``, the
    ``mixer`` leaves and, but for the ssm family, ``ln2``, the post-norms
    ``pn1`` and ``pn2`` where ``cfg.post_norm`` and the MLP."""
    leaves = {"ssm": _SSM_LEAVES, "rglru": _RGLRU_LEAVES,
              "attn": _ATTN_LEAVES + (_BIAS_LEAVES if cfg.qkv_bias else ())}
    for i, block in enumerate(modules):
        _copy(block.ln1, blocks["ln1"][i], f"{path}/ln1[{i}]")
        for name in leaves[mixer]:
            _copy(getattr(getattr(block, mixer), name),
                  blocks[mixer][name][i], f"{path}/{mixer}/{name}[{i}]")
        if mixer == "ssm":  # no FFN: the reference's ln2 is never read
            continue
        for name in ("ln2",) + (("pn1", "pn2") if cfg.post_norm else ()):
            _copy(getattr(block, name), blocks[name][i],
                  f"{path}/{name}[{i}]")
        for name in ("wi", "wo") + (("wg",) if GATED[cfg.act] else ()):
            _copy(getattr(block.mlp, name), blocks["mlp"][name][i],
                  f"{path}/mlp/{name}[{i}]")


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None):
    """A ``MambaLM`` (ssm), ``DenseLM`` (dense, audio) or ``HybridLM``
    (hybrid) on ``device`` (the card unless the caller asks for the CPU)
    holding the reference tree's weights, in the dtype of its head
    (``lm_head``, or the tied ``embed``)."""
    dtype = _tensor(tree["embed" if cfg.tie_embeddings else "lm_head"]).dtype
    dev = resolve_device(device)
    model = MODELS[cfg.family](cfg, dtype, dev)
    heads = ((("embed",) if cfg.frontend == "tokens" else ()) + ("ln_f",)
             + (() if cfg.tie_embeddings else ("lm_head",)))
    for name in heads:
        _copy(getattr(model, name), tree[name], name)
    if cfg.family == "hybrid":
        for group in ("rglru", "attn"):
            _copy_blocks(model.blocks[group], tree["blocks"][group], group,
                         cfg, f"blocks/{group}")
    else:
        _copy_blocks(model.blocks, tree["blocks"],
                     "ssm" if cfg.family == "ssm" else "attn", cfg, "blocks")
    return model
