"""zm_device_ms: device milliseconds a step in which a kernel, copy or
fill ran inside the program's span zm_conv_tend (ZM's deep convection:
zm_convr's level loops, the tail, the evaporation), between its markers."""


def read(record):
    from benchmark.metrics._spans import per_step_ms
    return per_step_ms(record, "zm_conv_tend", "busy_s")
