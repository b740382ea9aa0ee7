"""Port of ``repro.videostore``: the segment store and the video store."""
