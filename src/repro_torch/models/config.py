"""Architecture configuration schema for the model zoo; the port's copy of
``src/repro/models/config.py`` (pure data, kept in step with it).

One ``ArchConfig`` describes any of the supported families:

  dense | moe | hybrid (RG-LRU + local attn) | ssm (mamba1) | vlm | audio

The assigned architectures (``repro_torch.configs``) instantiate this schema with
exact published hyperparameters; smoke tests use ``reduced()`` copies.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0      # qwen2-moe: shared experts run for all tokens
    shared_gated: bool = True      # qwen2-moe gates shared output by a sigmoid
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    dense_ff: int = 0              # width of the parallel dense FFN
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16            # mamba1 N
    conv_width: int = 4
    expand: int = 2                # inner = expand * d_model
    dt_rank: int = 0               # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0             # 0 => d_model
    conv_width: int = 4
    block_pattern: tuple[str, ...] = ("rglru", "rglru", "attn")  # 2:1
    window: int = 2048             # local attention window


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # attention flavor
    causal: bool = True            # False: encoder-only (hubert)
    rope_theta: float = 10000.0
    mrope: bool = False            # qwen2-vl: multimodal 3D rope (t, h, w)
    qkv_bias: bool = False         # qwen1.5 / qwen2
    logit_softcap: float = 0.0     # gemma2: attention logit soft-capping
    final_softcap: float = 0.0     # gemma2: final logit soft-capping
    local_window: int = 0          # gemma2: sliding window for local layers
    local_global_alternate: bool = False  # gemma2: even layers local
    # norms / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"              # silu | gelu
    post_norm: bool = False        # gemma2 uses post-ffw/post-attn norms too
    # family extras
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # modality frontend stubs
    frontend: str = "tokens"       # tokens | patches (vlm) | frames (audio)
    # shapes this arch supports (decode steps need causal LM)
    supports_decode: bool = True
    subquadratic: bool = False     # can run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kind(self, i: int) -> str:
        """Block type of layer i: attn | local_attn | rglru | ssm."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            pat = self.rglru.block_pattern
            return "local_attn" if pat[i % len(pat)] == "attn" else "rglru"
        if self.local_global_alternate:
            return "local_attn" if i % 2 == 0 else "attn"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        return self.family == "moe" and self.moe is not None

    def reduced(self, n_layers: int = 2, d_model: int = 64, n_heads: int = 4,
                n_kv_heads: int | None = None, d_ff: int = 128,
                vocab: int = 512, n_experts: int | None = None
                ) -> "ArchConfig":
        """A tiny same-family copy for CPU smoke tests."""
        kv = n_kv_heads if n_kv_heads is not None else max(
            1, n_heads * self.n_kv_heads // max(self.n_heads, 1) or 1)
        kv = max(1, min(kv, n_heads))
        while n_heads % kv:
            kv -= 1
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=n_experts or min(8, moe.n_experts),
                top_k=min(moe.top_k, n_experts or 8),
                n_shared_experts=min(1, moe.n_shared_experts),
                dense_ff=d_ff if moe.dense_residual else 0)
        rglru = self.rglru
        if rglru is not None:
            rglru = dataclasses.replace(rglru, lru_width=d_model, window=32)
            n_layers = max(n_layers, len(rglru.block_pattern))  # >=1 attn
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, state_dim=8)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers,
            d_model=d_model, n_heads=n_heads, n_kv_heads=kv, d_ff=d_ff,
            vocab_size=vocab, head_dim=0, moe=moe, rglru=rglru, ssm=ssm,
            local_window=min(self.local_window, 16) if self.local_window else 0)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks); used for roofline
        MODEL_FLOPS = 6·N·D."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(L):
            kind = self.layer_kind(i)
            if kind in ("attn", "local_attn"):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
            elif kind == "rglru":
                w = self.rglru.lru_width or d
                total += 2 * d * w + w * d + 2 * w * self.rglru.conv_width \
                    + 2 * w * w  # in/out proj + conv + gates
            elif kind == "ssm":
                inner = self.ssm.expand * d
                dt_rank = self.ssm.dt_rank or -(-d // 16)
                total += 2 * d * inner + inner * d \
                    + inner * self.ssm.conv_width \
                    + inner * (dt_rank + 2 * self.ssm.state_dim) \
                    + dt_rank * inner + inner * self.ssm.state_dim
            # FFN / MoE
            if kind == "ssm":
                continue  # mamba blocks have no separate FFN
            if self.is_moe_layer(i):
                m = self.moe
                total += 3 * d * self.d_ff * (m.n_experts + m.n_shared_experts)
                total += d * m.n_experts  # router
                if m.dense_residual:
                    total += 3 * d * m.dense_ff
            else:
                n_mats = 3 if self.act in ("silu", "geglu") else 2
                total += n_mats * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        m = self.moe
        full = self.param_count()
        all_experts = L * 3 * d * self.d_ff * m.n_experts
        active_experts = L * 3 * d * self.d_ff * m.top_k
        return full - all_experts + active_experts
