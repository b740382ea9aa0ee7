"""The port's language model (``src/repro/models/transformer.py``), ssm,
dense, hybrid and audio families: ``MambaLM``, ``DenseLM``, ``HybridLM``,
``init_params`` and ``forward``.

    model  = init_params(cfg, seed, dtype, device)
    logits = forward(model, cfg, batch)                 # train / no-cache
    logits = forward(model, cfg, {"embeds": x})         # audio: encode

The reference stacks its layers on a leading axis for ``lax.scan``; the
port keeps one block per layer in a ``ModuleList``.  An ssm block is
``x + MambaMixer(rms_norm(x, ln1))``: the ssm family has no FFN, so the
reference's ``ln2``, which it initialises and never reads, has no
counterpart there.  A dense block is the reference's ``_attn_block`` and
``_ffn`` without MoE: ``x + attn(rms_norm(x, ln1))``, then ``x +
mlp(rms_norm(x, ln2))``; with gemma2's post-norms each branch's output
passes ``rms_norm`` with ``pn1`` / ``pn2`` before its residual add.
Gemma2 alternates local and global layers (``cfg.layer_kind``: even
layers local); where the reference's ``_dual_window_block`` runs
attention under both masks and selects one, the port builds each block
with its own layer's window and runs one K4 launch with that mask, the
logit soft-cap ``cfg.logit_softcap`` in both, and soft-caps the logits at
``cfg.final_softcap``.  The hybrid family
(RecurrentGemma) interleaves RG-LRU blocks (``_rglru_block``: the same
shape with the RG-LRU mixer in place of attention) with local-attention
blocks (a dense block with the RG-LRU config's window), kept in the
reference's two groups and run in the order of ``cfg.layer_kind``.  The
audio family (HuBERT) is a ``DenseLM`` that takes the reference's
``frontend == "frames"`` branch at its input: no embedding, frame
embeddings (B, S, d) in, then the dense blocks with bidirectional
attention (``cfg.causal`` False), RoPE from positions [0, S), ``ln_f`` and
an untied head; it has no decode step.  The other
families wait for the slices that bring them (ROADMAP §1).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import Attention, init_attention
from .config import ArchConfig
from .layers import (MLP, init_mlp, matmul, param, rms_norm, rope_table,
                     softcap, truncated_normal)
from .recurrent import MambaMixer, RGLRUMixer, init_mamba, init_rglru

#: the slice that will bring each family not ported yet (ROADMAP §1)
_WAITING = {
    "vlm": "the vlm family's slice (M-RoPE, the patches frontend), with "
           "the rest of the LM scaffold",
    "moe": "the rest of the LM scaffold (MoE layers)",
}


def require_served(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the slice that brings ``cfg``
    unless the port runs it: the ssm and hybrid families, the dense family
    (gemma2's features included), and the audio family's encoder
    (``forward`` only: its missing decode step is refused by
    ``models/serving.py`` and ``launch/serve.py``, as the reference refuses
    it)."""
    if cfg.family not in ("ssm", "dense", "hybrid", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the port has the ssm, dense, hybrid and audio "
            f"families only; the {cfg.family!r} family waits for "
            f"{_WAITING.get(cfg.family, 'a later slice')}")
    if cfg.family == "audio":
        if cfg.frontend != "frames" or cfg.causal:
            raise NotImplementedError(
                f"{cfg.name}: the port's audio family is a non-causal "
                f"frame encoder only")
    elif cfg.frontend != "tokens" or not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: the port's {cfg.family} family is a causal token "
            f"model only")
    if cfg.family in ("ssm", "audio") and cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} path has untied embeddings only")
    if cfg.family == "hybrid" and (cfg.logit_softcap or cfg.final_softcap
                                   or cfg.post_norm):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid path has no soft-caps or post-norms "
            f"(no hybrid config has them)")


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                        requires_grad=False)


class MambaBlock(nn.Module):
    """``x + MambaMixer(rms_norm(x, ln1))``; with a state, one decode step
    (or a prefill from that state) that also returns the new state."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm(cfg.d_model, device)
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
        require_served(cfg)
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: MambaLM takes the ssm family")
        device = resolve_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = param((v, d), dtype, device)
        self.ln_f = _norm(d, device)
        self.lm_head = param((d, v), dtype, device)
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


class DenseBlock(nn.Module):
    """``x + attn(rms_norm(x, ln1))``, then ``x + mlp(rms_norm(x, ln2))``;
    with ``cfg.post_norm`` (gemma2) ``x + rms_norm(attn(...), pn1)``, then
    ``x + rms_norm(mlp(...), pn2)``.  ``forward`` runs the sequence over
    itself (query i over keys within ``window`` of it when that is > 0:
    the hybrid family's and gemma2's local attention; over every key when
    ``cfg.causal`` is False: the audio family's encoder), its scores
    soft-capped at ``cfg.logit_softcap`` when that is > 0, and also
    returns its roped k and v (for the prefill's cache); ``decode`` runs
    one token per row over the cache, writing its k/v into it first."""

    def __init__(self, cfg: ArchConfig, dtype, device, window: int = 0):
        super().__init__()
        self.eps = cfg.norm_eps
        self.window = window
        self.causal = cfg.causal
        self.logit_cap = cfg.logit_softcap
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        if cfg.post_norm:
            self.pn1 = _norm(cfg.d_model, device)
            self.pn2 = _norm(cfg.d_model, device)
        self.post_norm = cfg.post_norm
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device)

    def _residual(self, x: torch.Tensor, y: torch.Tensor,
                  post: str) -> torch.Tensor:
        if self.post_norm:
            y = rms_norm(y, getattr(self, post), self.eps)
        return x + y

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self._residual(x, self.mlp(rms_norm(x, self.ln2, self.eps)),
                              "pn2")

    def forward(self, x: torch.Tensor, rope):
        q, k, v = self.attn.qkv_project(rms_norm(x, self.ln1, self.eps), rope)
        o = self.attn.attention(q, k, v, self.window, self.causal,
                                self.logit_cap)
        x = self._residual(x, self.attn.out_project(o), "pn1")
        return self._ffn(x), k, v

    def decode(self, x: torch.Tensor, rope, k_cache: torch.Tensor,
               v_cache: torch.Tensor, slot: int,
               k_len: int) -> torch.Tensor:
        """Writes the token's k/v at ``slot`` and attends over the first
        ``k_len`` positions within the block's window: ``(pos, pos + 1)``
        in a linear cache (a gemma2 local layer's token sees its last
        ``window`` positions), or ``(pos % w, min(pos + 1, w))`` in a ring
        of ``w <= window`` (which holds exactly the last keys the token may
        see, so the window keeps every one).  The cache may be of another
        dtype than the model (bfloat16 under float32 weights); the k/v are
        cast into it."""
        q, k, v = self.attn.qkv_project(rms_norm(x, self.ln1, self.eps), rope)
        write_kv(k_cache, v_cache, k, v, slot)
        o = self.attn.decode_attention(q, k_cache, v_cache, k_len,
                                       self.window, self.logit_cap)
        return self._ffn(self._residual(x, self.attn.out_project(o), "pn1"))


def write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, start: int) -> None:
    """Write k, v (B, S, KV, hd) into the caches (B, S_max, KV, hd) at
    positions [start, start + S), cast to the cache dtype as the
    reference's ``_write_kv`` casts them, in place (the reference returns
    new arrays)."""
    s = k.shape[1]
    if start + s > k_cache.shape[1]:
        raise ValueError(f"KV cache of {k_cache.shape[1]} positions is full "
                         f"(writing [{start}, {start + s}))")
    k_cache[:, start:start + s] = k
    v_cache[:, start:start + s] = v


class _LM(nn.Module):
    """What the dense, hybrid and audio models share: a token model's
    embedding ``embed`` (a frame encoder has none), the final norm ``ln_f``
    and the head: ``lm_head`` (d, vocab), or with tied embeddings ``embed``
    transposed, the input then scaled by sqrt(d) in the embedding's dtype
    as the reference scales it; RoPE tables for the attention layers.
    Reference layouts, on ``device`` (the card unless the caller asks for
    the CPU).  Built empty; ``init_params`` or
    ``convert.params_from_numpy`` fill it."""

    families: tuple = ()

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        require_served(cfg)
        if cfg.family not in self.families:
            raise ValueError(f"{cfg.name}: {type(self).__name__} takes the "
                             f"{' or '.join(self.families)} family")
        device = resolve_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        if cfg.frontend == "tokens":
            self.embed = param((v, d), dtype, device)
        self.ln_f = _norm(d, device)
        if not cfg.tie_embeddings:
            self.lm_head = param((d, v), dtype, device)

    @property
    def dtype(self) -> torch.dtype:
        return (self.embed if self.cfg.tie_embeddings else self.lm_head).dtype

    def _inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        """The first block's input: the embedding of tokens (B, S), or
        floating-point frame embeddings (B, S, d) as they are.  Embeddings
        of another dtype than the weights are promoted with them in every
        product (``layers.matmul``), as the reference's ``x @ wq`` promotes
        them: float32 frames over bfloat16 weights run in float32."""
        if self.cfg.frontend == "tokens":
            return self._embed(inputs)
        if inputs.dim() != 3 or inputs.shape[-1] != self.cfg.d_model:
            raise ValueError(f"{self.cfg.name}: embeds must be (B, S, "
                             f"{self.cfg.d_model}), got {tuple(inputs.shape)}")
        if not inputs.is_floating_point():
            raise ValueError(f"{self.cfg.name}: embeds must be floating "
                             f"point, got {inputs.dtype}")
        return inputs

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _rope_fn(self, x: torch.Tensor, start: int):
        """RoPE table of positions ``start + [0, S)`` for every row of ``x``
        (tokens (B, S) or embeddings (B, S, d); plain RoPE, M-RoPE waits
        for the vlm family)."""
        b, s = x.shape[:2]
        pos = torch.arange(start, start + s, device=x.device)
        return rope_table(pos.expand(b, s), self.cfg.resolved_head_dim,
                          self.cfg.rope_theta)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm, head and gemma2's final soft-cap (none elsewhere)."""
        x = rms_norm(x, self.ln_f, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return softcap(matmul(x, head), self.cfg.final_softcap)


class DenseLM(_LM):
    """Embedding (a frame encoder has none), ``n_layers`` dense blocks,
    final norm and head (``_LM``): the dense family, gemma2's local layers
    (``cfg.layer_kind`` "local_attn") built with ``cfg.local_window``, and
    the audio family's encoder (HuBERT), whose blocks attend
    bidirectionally and which has no decode step."""

    families = ("dense", "audio")

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, dtype, self.ln_f.device,
                       window=cfg.local_window
                       if cfg.layer_kind(i) == "local_attn" else 0)
            for i in range(cfg.n_layers))

    def run(self, inputs: torch.Tensor, kv: tuple | None = None
            ) -> torch.Tensor:
        """tokens (B, S), or frame embeddings (B, S, d) (``_inputs``), at
        positions [0, S) -> logits (B, S, vocab).  With ``kv`` (per-layer
        lists of k and v caches), each layer's roped k/v are also written
        into its cache at [0, S)."""
        x = self._inputs(inputs)
        rope = self._rope_fn(inputs, 0)
        for i, block in enumerate(self.blocks):
            x, k, v = block(x, rope)
            if kv is not None:
                write_kv(kv[0][i], kv[1][i], k, v, 0)
        return self._logits(x)

    def step(self, tokens: torch.Tensor, kv: tuple, pos: int) -> torch.Tensor:
        """tokens (B, 1) at position ``pos`` over caches holding positions
        [0, pos) -> logits (B, 1, vocab); writes the token's k/v at
        ``pos``; a local layer attends within its window of the cache."""
        x = self._embed(tokens)
        rope = self._rope_fn(tokens, pos)
        for i, block in enumerate(self.blocks):
            x = block.decode(x, rope, kv[0][i], kv[1][i], pos, pos + 1)
        return self._logits(x)


class RGLRUBlock(nn.Module):
    """``x + RGLRUMixer(rms_norm(x, ln1))``, then ``x + mlp(rms_norm(x,
    ln2))`` (the reference's ``_rglru_block``); with a state, one decode
    step (or a prefill from that state).  Returns (x, new state)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        self.rglru = RGLRUMixer(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device)

    def forward(self, x: torch.Tensor, state: dict | None = None):
        out, new_state = self.rglru(rms_norm(x, self.ln1, self.eps), state)
        x = x + out
        return x + self.mlp(rms_norm(x, self.ln2, self.eps)), new_state


def ring_fill(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Write a prompt's k, v (B, S, KV, hd) into ring caches (B, w, KV,
    hd) in place: the last ``w`` positions ``p`` at slot ``p % w``, as the
    reference's ``_prefill_recurrent`` fills them, cast to the ring's
    dtype.  With S < w, slots S..w-1
    take position S-1's k/v, as the reference's clipped gather gives them
    (decode never reads them before overwriting them)."""
    w, s = k_cache.shape[1], k.shape[1]
    take = torch.arange(w, device=k.device) + max(s - w, 0)
    slots, src = take % w, take.clamp(0, s - 1)
    k_cache[:, slots] = k[:, src].to(k_cache.dtype)
    v_cache[:, slots] = v[:, src].to(v_cache.dtype)


class HybridLM(_LM):
    """Embedding, the RG-LRU and local-attention blocks, final norm and
    head (``_LM``).  ``blocks["rglru"]`` and ``blocks["attn"]`` hold
    the two kinds in the reference's stacked grouping; ``order`` lists
    ``(kind, index in its group)`` layer by layer, in the order of
    ``cfg.layer_kind``.  The attention blocks attend within
    ``cfg.rglru.window`` keys."""

    families = ("hybrid",)

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        dev = self.ln_f.device
        kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
        self.order = [("rglru" if k == "rglru" else "attn",
                       sum(j == k for j in kinds[:i]))
                      for i, k in enumerate(kinds)]
        self.blocks = nn.ModuleDict({
            "rglru": nn.ModuleList(RGLRUBlock(cfg, dtype, dev)
                                   for k in kinds if k == "rglru"),
            "attn": nn.ModuleList(DenseBlock(cfg, dtype, dev,
                                             window=cfg.rglru.window)
                                  for k in kinds if k != "rglru")})

    def run(self, tokens: torch.Tensor, kv: tuple | None = None):
        """tokens (B, S) at positions [0, S) from zero states -> (logits
        (B, S, vocab), the RG-LRU blocks' final states).  With ``kv``
        (lists of ring k and v caches, one per attention block), each
        attention block's roped k/v are also written into its ring
        (``ring_fill``)."""
        x = self._embed(tokens)
        rope = self._rope_fn(tokens, 0)
        states = []
        for kind, n in self.order:
            if kind == "rglru":
                x, st = self.blocks["rglru"][n](x)
                states.append(st)
            else:
                x, k, v = self.blocks["attn"][n](x, rope)
                if kv is not None:
                    ring_fill(kv[0][n], kv[1][n], k, v)
        return self._logits(x), states

    def step(self, tokens: torch.Tensor, kv: tuple, states: list, pos: int):
        """tokens (B, 1) at position ``pos`` over rings holding the last
        keys before it and the RG-LRU states after [0, pos) -> (logits
        (B, 1, vocab), new states); writes the token's k/v at ``pos % w``
        of each ring of ``w``."""
        x = self._embed(tokens)
        rope = self._rope_fn(tokens, pos)
        new_states = []
        for kind, n in self.order:
            if kind == "rglru":
                x, st = self.blocks["rglru"][n](x, states[n])
                new_states.append(st)
            else:
                w = kv[0][n].shape[1]
                x = self.blocks["attn"][n].decode(
                    x, rope, kv[0][n], kv[1][n], pos % w, min(pos + 1, w))
        return self._logits(x), new_states


#: the port's model class of each family it runs
MODELS = {"ssm": MambaLM, "dense": DenseLM, "hybrid": HybridLM,
          "audio": DenseLM}


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None):
    """A ``MambaLM`` (ssm), ``DenseLM`` (dense, audio) or ``HybridLM``
    (hybrid) with weights drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless the caller asks
    for the CPU), with the reference's distributions: a token model's
    embedding N(0, 1) (tied: at scale d^-0.5) and ``lm_head`` at d^-0.5,
    truncated at 2 sigma; norms (gemma2's post-norms too) and biases
    zero."""
    require_served(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = MODELS[cfg.family](cfg, dtype, dev)
    emb_scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    with torch.no_grad():
        if cfg.frontend == "tokens":
            model.embed.copy_(truncated_normal(model.embed.shape, emb_scale,
                                               dtype, gen, dev))
        if not cfg.tie_embeddings:
            model.lm_head.copy_(truncated_normal(
                model.lm_head.shape, cfg.d_model ** -0.5, dtype, gen, dev))
    for block in model.modules():
        if isinstance(block, MambaBlock):
            init_mamba(block.ssm, gen)
        elif isinstance(block, RGLRUBlock):
            init_rglru(block.rglru, gen)
            init_mlp(block.mlp, gen)
        elif isinstance(block, DenseBlock):
            init_attention(block.attn, gen)
            init_mlp(block.mlp, gen)
    return model


@torch.no_grad()
def forward(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S), or for the audio family (``cfg.frontend ==
    "frames"``) floating-point embeds (B, S, d).  Returns logits
    (B, S, vocab), from zero states (ssm, hybrid) and without a cache."""
    out = params.run(batch["embeds" if cfg.frontend == "frames"
                           else "tokens"])
    return out if isinstance(params, DenseLM) else out[0]
