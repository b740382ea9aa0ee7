"""Gemma2-2B [arXiv:2408.00118]: local(4096)+global alternating attention,
logit softcapping (attn 50, final 30), post-norms, GeGLU, head_dim=256."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
    n_heads=8, n_kv_heads=4, d_ff=9216, vocab_size=256000, head_dim=256,
    act="geglu", logit_softcap=50.0, final_softcap=30.0,
    local_window=4096, local_global_alternate=True, post_norm=True,
    tie_embeddings=True,
)
