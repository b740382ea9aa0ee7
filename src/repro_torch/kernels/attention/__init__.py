"""attention kernel: K4 (flash attention, causal, GQA, over a KV cache)."""
