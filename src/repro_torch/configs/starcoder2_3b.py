"""StarCoder2-3B [arXiv:2402.19173]: dense decoder, GQA (kv=2), RoPE,
GeLU MLP (non-gated), learned... (we use RoPE per config block)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab_size=49152,
    rope_theta=1e5, act="gelu", qkv_bias=True,
)
