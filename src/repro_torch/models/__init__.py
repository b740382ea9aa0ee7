"""The port's model zoo (``src/repro/models``): the ssm family (Mamba-1),
the dense family (GQA transformers) and the hybrid family (RG-LRU with
local attention) so far, with their serving path, and the audio family's
encoder (HuBERT: a ``DenseLM`` whose ``forward`` takes frame embeddings;
no serving path)."""

from .config import ArchConfig, MoEConfig, RGLRUConfig, SSMConfig
from .serving import decode_step, init_cache, prefill
from .transformer import DenseLM, HybridLM, MambaLM, forward, init_params

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig", "MambaLM",
    "DenseLM", "HybridLM",
    "init_params", "forward", "init_cache", "prefill", "decode_step",
]
