"""dyn_run_device_ms: device milliseconds a step in which a kernel, copy
or fill ran inside the program's span dyn_run (the dycore's large step:
the port's kernels and the PyTorch glue between them), between its
markers."""


def read(record):
    from benchmark.metrics._spans import per_step_ms
    return per_step_ms(record, "dyn_run", "busy_s")
