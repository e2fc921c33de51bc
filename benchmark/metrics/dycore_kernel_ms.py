"""dycore_kernel_ms: device milliseconds a step of the port's dycore
kernels (K1-K4 with their DFT products and row kernels, tracer_div3d's
row kernels, te_map_remap), by name (kernels.json "dycore")."""


def read(record):
    from benchmark.metrics._common import KERNELS, kernel_seconds
    calls, secs = kernel_seconds(record, KERNELS["dycore"])
    if not calls or not record["steps"]:
        return None
    return 1e3 * secs / record["steps"]
