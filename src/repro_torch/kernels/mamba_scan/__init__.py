"""mamba_scan kernel: K5 (Mamba-1 selective scan)."""
