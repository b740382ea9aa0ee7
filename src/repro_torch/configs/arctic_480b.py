"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: dense-MoE hybrid —
128 experts top-2 in parallel with a dense residual FFN; GQA kv=8."""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
    act="silu",
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True,
                  dense_ff=4864),
)
