"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4 +
4 shared experts (sigmoid-gated), fine-grained expert d_ff=1408."""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=151936,
    act="silu", qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4,
                  shared_gated=True),
)
