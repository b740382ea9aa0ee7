"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio transformer
(w2v2-style backbone), bidirectional attention, masked-prediction head over
504 cluster targets.  Audio frontend is a stub: input_specs() supplies
precomputed frame embeddings."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504,
    act="gelu", causal=False, frontend="frames", supports_decode=False,
)
