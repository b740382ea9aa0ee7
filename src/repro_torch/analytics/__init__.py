"""Port of ``repro.analytics``: scenes, the six operators and cascade queries."""
