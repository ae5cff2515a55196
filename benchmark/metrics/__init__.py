"""One reader per metric, found by the metric's name. Each declares its
unit, source, layer and the end-to-end metric it moves (per-layer metrics),
and `read(readings)` returns the value or None where the run gave it
nothing to read."""
