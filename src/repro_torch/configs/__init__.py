"""Assigned-architecture registry: ``get_config(arch_id)``; the port's
copy of ``src/repro/configs``.

Each module holds the exact published configuration; ``reduced()`` copies
are used by CPU smoke tests.  The paper's own analytics operators live in
``repro_torch.analytics`` (they are image programs, not LM configs).
"""
from . import (arctic_480b, falcon_mamba_7b, gemma2_2b, hubert_xlarge,
               qwen1_5_0_5b, qwen2_moe_a2_7b, qwen2_vl_72b,
               recurrentgemma_9b, smollm_135m, starcoder2_3b)

ARCHS = {
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
}


def get_config(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
