"""Step builders of the port (``src/repro/train/train_step.py``): the
serve step.  ``make_train_step`` waits for the training slice."""

from __future__ import annotations

import torch

from ..models import decode_step
from ..models.config import ArchConfig


def make_serve_step(cfg: ArchConfig):
    """Returns serve_step(params, batch, cache) -> (token (B,), cache):
    one ``decode_step`` and a greedy argmax over its logits, for any family
    the port serves (``decode_step`` dispatches on ``cfg.family``)."""

    def serve_step(params, batch, cache):
        logits, cache = decode_step(params, cfg, batch, cache)
        return torch.argmax(logits, dim=-1), cache

    return serve_step
