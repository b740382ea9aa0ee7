"""Weights carried across from the reference: a ``repro.models``
parameter tree, as numpy arrays, into the port's ``MambaLM``.

The tree is what ``repro.models.init_params`` returns for an ssm-family
config, converted leaf by leaf with ``numpy.asarray``: ``embed``,
``ln_f``, ``lm_head`` and ``blocks``, whose leaves carry the layers on
axis 0 (``blocks/ln1`` (L, d), ``blocks/ssm/in_proj`` (L, d, 2·inner),
...).  ``blocks/ln2`` is dropped: the reference initialises it for every
family but the ssm family has no FFN and never reads it.  Layouts are the
same on both sides, so each leaf is copied as it is; bfloat16 leaves
(``ml_dtypes``) are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig
from .transformer import MambaLM

_SSM_LEAVES = ("in_proj", "conv", "x_proj", "dt_proj", "dt_bias", "a_log",
               "d", "out_proj")


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


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> MambaLM:
    """A ``MambaLM`` on ``device`` (the card unless the caller asks for the
    CPU) holding the reference tree's weights, in the tree's projection
    dtype."""
    model = MambaLM(cfg, _tensor(tree["embed"]).dtype,
                    resolve_device(device))
    for name in ("embed", "ln_f", "lm_head"):
        _copy(getattr(model, name), tree[name], name)
    blocks = tree["blocks"]
    for i, block in enumerate(model.blocks):
        _copy(block.ln1, blocks["ln1"][i], f"blocks/ln1[{i}]")
        for name in _SSM_LEAVES:
            _copy(getattr(block.ssm, name), blocks["ssm"][name][i],
                  f"blocks/ssm/{name}[{i}]")
    return model
