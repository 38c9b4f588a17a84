"""Engine templates ported so far: the recommendation template."""
