"""Qwen2-VL-72B [arXiv:2409.12191]: VLM backbone — M-RoPE (t,h,w) rotary,
GQA kv=8, QKV bias.  Vision frontend is a stub: input_specs() supplies
precomputed patch embeddings + mrope position triples."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab_size=152064,
    act="silu", qkv_bias=True, mrope=True, frontend="patches",
)
