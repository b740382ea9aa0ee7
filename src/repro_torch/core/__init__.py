"""Port of ``repro.core``: the knob spaces and the data half of the configuration."""
