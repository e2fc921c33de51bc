"""device_idle_pct: the share of the traced window in which no kernel,
copy or fill ran on the device (the union of their intervals), in %."""


def read(record):
    if record["window_s"] <= 0 or record["busy_s"] <= 0:
        return None
    return 100.0 * (record["window_s"] - record["busy_s"]) / record["window_s"]
