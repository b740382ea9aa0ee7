"""Port of ``repro.obs``: trace spans."""
