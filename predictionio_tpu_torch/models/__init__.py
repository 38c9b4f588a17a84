"""Engine templates ported so far: the recommendation and sequential templates."""
