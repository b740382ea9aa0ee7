"""The port's language model (``src/repro/models/transformer.py``), ssm
family: ``MambaLM``, ``init_params`` and ``forward``.

    model  = init_params(cfg, seed, dtype, device)
    logits = forward(model, cfg, batch)                 # train / no-cache

The reference stacks its layers on a leading axis for ``lax.scan``; the
port keeps one ``MambaBlock`` per layer in a ``ModuleList``.  A block is
``x + MambaMixer(rms_norm(x, ln1))``: the ssm family has no FFN, so the
reference's ``ln2``, which it initialises and never reads, has no
counterpart here.  The other families wait for the slices that bring
their kernels (ROADMAP §1).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .config import ArchConfig
from .layers import rms_norm, softcap, truncated_normal
from .recurrent import MambaMixer, init_mamba

#: the slice that will bring each family not ported yet (ROADMAP §1)
_WAITING = {
    "dense": "the dense / gemma2 serving slice (K4 flash_attention)",
    "vlm": "the dense / gemma2 serving slice (K4 flash_attention)",
    "audio": "the dense / gemma2 serving slice (K4 flash_attention)",
    "moe": "the rest of the LM scaffold, after the dense serving slice "
           "(K4 flash_attention)",
    "hybrid": "the recurrentgemma serving slice (K4 and K6 rglru_scan)",
}


def _require_ssm(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the port has the ssm family only; the "
            f"{cfg.family!r} family waits for "
            f"{_WAITING.get(cfg.family, 'a later slice')}")
    if cfg.tie_embeddings or cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the ssm path has untied embeddings and a token "
            f"frontend only")


class MambaBlock(nn.Module):
    """``x + MambaMixer(rms_norm(x, ln1))``; with a state, one decode step
    (or a prefill from that state) that also returns the new state."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, dtype=torch.float32,
                                            device=device),
                                requires_grad=False)
        self.ssm = MambaMixer(cfg, dtype, device)

    def forward(self, x: torch.Tensor, state: dict | None = None):
        out, new_state = self.ssm(rms_norm(x, self.ln1, self.eps), state)
        return x + out, new_state


class MambaLM(nn.Module):
    """Embedding, ``n_layers`` Mamba blocks, final norm ``ln_f`` and an
    untied ``lm_head`` (d, vocab), in the reference's layouts, on
    ``device`` (the card unless the caller asks for the CPU).  Built empty;
    ``init_params`` or ``convert.params_from_numpy`` fill it."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        _require_ssm(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((v, d), dtype=dtype,
                                              device=device),
                                  requires_grad=False)
        self.ln_f = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                             device=device),
                                 requires_grad=False)
        self.lm_head = nn.Parameter(torch.empty((d, v), dtype=dtype,
                                                device=device),
                                    requires_grad=False)
        self.blocks = nn.ModuleList(MambaBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def run(self, tokens: torch.Tensor, states: list | None = None):
        """tokens (B, S) -> (logits (B, S, vocab), new per-layer states),
        each block started from ``states[i]`` (None: zero states)."""
        x = self.embed[tokens]
        new_states = []
        for i, block in enumerate(self.blocks):
            x, st = block(x, None if states is None else states[i])
            new_states.append(st)
        x = rms_norm(x, self.ln_f, self.cfg.norm_eps)
        return softcap(x @ self.lm_head, self.cfg.final_softcap), new_states


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> MambaLM:
    """A ``MambaLM`` with weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless the caller asks for the
    CPU), with the reference's distributions: embedding N(0, 1) and
    ``lm_head`` at scale d^-0.5, truncated at 2 sigma; norms zero."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = MambaLM(cfg, dtype, dev)
    with torch.no_grad():
        model.embed.copy_(truncated_normal(model.embed.shape, 1.0, dtype,
                                           gen, dev))
        model.lm_head.copy_(truncated_normal(
            model.lm_head.shape, cfg.d_model ** -0.5, dtype, gen, dev))
    for block in model.blocks:
        init_mamba(block.ssm, gen)
    return model


@torch.no_grad()
def forward(params: MambaLM, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S).  Returns logits (B, S, vocab) from a zero
    state."""
    return params.run(batch["tokens"])[0]
