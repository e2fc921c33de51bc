"""host_gap_ms: milliseconds a step in which the device sat idle outside
every span of the program, between the window's first span and its last:
the loop's glue, samples and sentinels, and the launch of the next
dispatch or graph replay. The window's head and tail, once a window, are
left out (harness/spans.py)."""


def read(record):
    from benchmark.metrics._spans import per_step_ms
    return per_step_ms(record, "outside", "between_idle_s")
