"""The benchmark of the PyTorch and CUDA port (cam_nor_physics_tpu_torch).

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by its name:
configs/<config>.json, traffic/<traffic>.json (whose "entry" names a
module of entries/), metrics/<metric>.py. reference/ is the plain
reference that decides `correct`; harness/ is the yardstick (the frozen
work count and peaks, the trace reduction, the comparison).
"""
