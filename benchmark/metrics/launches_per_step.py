"""launches_per_step: device kernels a step in the traced window (the
host launch path's load; ZM's level loops launch most of them)."""


def read(record):
    if not record["kernels"] or not record["steps"]:
        return None
    return record["kernels"] / record["steps"]
