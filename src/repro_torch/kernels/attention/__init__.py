"""attention kernel: K4 (flash attention: causal or not, GQA, sliding
window, logit soft-cap, over a prompt or a KV cache)."""
