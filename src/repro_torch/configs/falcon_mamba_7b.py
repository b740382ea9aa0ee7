"""Falcon-Mamba-7B [arXiv:2410.05355]: attention-free mamba-1 architecture,
64 layers, ssm_state=16, expand=2 (inner 8192)."""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=65024,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    subquadratic=True,
)
