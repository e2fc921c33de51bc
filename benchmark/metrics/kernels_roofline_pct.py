"""kernels_roofline_pct: the port's own kernels' share of their roofline,
in %: the sum of their bounds over the sum of their device time in the
traced window.

A call's bound is the larger of its bytes over the HBM rate and its
operations over the float32 rate (harness/work.py's peaks), its bytes and
operations from the frozen kernel_work at the configuration's shapes:
"work"/"kernels" of the configuration file holds, for one step, each
kernel's [calls, bytes, operations] (tools/count_work.py). Device time is
that of the kernels named in kernels.json."""


def read(record):
    from benchmark.harness.work import bound_s
    from benchmark.metrics._common import kernel_seconds, peak, port_kernels
    work = record["config"].get("work", {}).get("kernels")
    calls, secs = kernel_seconds(record, port_kernels())
    pk = peak(record)
    if not work or not pk or not calls or secs <= 0:
        return None
    per_step = sum(n * bound_s(b / n, o / n, pk)
                   for n, b, o in work.values() if n)
    return 100.0 * per_step * record["steps"] / secs
