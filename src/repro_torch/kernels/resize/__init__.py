"""resize kernel: K2 (antialiased bilinear resize)."""
