"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: dense, MHA (kv=16), QKV bias,
SiLU-gated MLP, tied embeddings."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab_size=151936,
    act="silu", qkv_bias=True, tie_embeddings=True,
)
