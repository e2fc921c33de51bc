"""mfu: the whole step's share of the card's float32 peak, in %.

The operations a step needs are data, counted once over the frozen
reference at the configuration's shapes (configuration file, "work":
tools/count_work.py): never recounted from the program. Value: operations
a step x the steps of the run's untraced window / its seconds / the
peak (the traced window runs slower under the profiler)."""


def read(record):
    from benchmark.metrics._common import peak
    ops = record["config"].get("work", {}).get("ops_per_step")
    pk = peak(record)
    steps, secs = record["host_steps"], record["host_window_s"]
    if not ops or not pk or not steps or secs <= 0:
        return None
    return 100.0 * ops * steps / secs / pk["f32_ops_per_s"]
