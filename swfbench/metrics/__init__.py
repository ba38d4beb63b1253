"""Per-layer metric readers: ``metrics/<name>.py`` has ``read(traced)``,
which returns the metric's value from the traced run, or None when the
run has nothing to read for it."""
