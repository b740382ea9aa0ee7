"""RecurrentGemma-9B [arXiv:2402.19427 Griffin]: RG-LRU + local attention,
2:1 pattern, window 2048, GQA kv=1 on the attention layers."""
from ..models.config import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256000, head_dim=256,
    act="geglu", tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      block_pattern=("rglru", "rglru", "attn"), window=2048),
    subquadratic=True,
)
