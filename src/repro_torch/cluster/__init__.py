"""Port of ``repro.cluster``: the wire forms of the spec and the configuration."""
