"""attention kernel: K4 (flash attention, causal, GQA, sliding window, over a KV cache)."""
