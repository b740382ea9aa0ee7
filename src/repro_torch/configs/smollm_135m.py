"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-architecture small
model — GQA (kv=3), RoPE, SiLU-gated MLP, tied embeddings."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, d_ff=1536, vocab_size=49152,
    act="silu", tie_embeddings=True,
)
