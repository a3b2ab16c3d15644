"""One reader per metric, found by the metric's name: read(ctx) returns
the value, or None when the run holds nothing to read."""
