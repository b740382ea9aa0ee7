"""Port of ``repro.codec``: transform coding and the segment blob format."""
