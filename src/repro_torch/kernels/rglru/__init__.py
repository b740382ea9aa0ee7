"""rglru kernel: K6 (RG-LRU gated linear recurrence)."""
