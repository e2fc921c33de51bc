"""Per-layer metrics: metrics/<name>.py has `read(record)`, which takes
the traced window's record (harness/trace.reduce_events, plus `steps`,
the configuration and the device) and returns the metric's value, or
None where the window holds nothing to read."""
