"""What decides `correct`: the program's states against the reference's,
started from the same state.

Each check advances one start state by the same steps on both sides and
compares the dycore's prognostic fields (u, v, pt, delp and each tracer
of q). A field's error is the RMS of program minus reference over the
RMS of the reference's own change from the start: 0 where the two agree,
1 where the program did not move the field, and about 1 or more where it
moved it wrongly (fields whose reference change is zero are left out).
Each compared number (the configuration's "compared" table) is the
largest error over its check's fields. A number that is NaN, or above its
limit, makes the run not correct.
"""

from __future__ import annotations

import math

import torch


# who can follow a check in the program's place: (dtype it computes in,
# dtype the state is stored in between steps). "reference" decides
# `correct`. "control" is the reference with its state held in bfloat16,
# the precision below the configurations' float32 (TF32 would change
# nothing: no step runs a matmul); "plain32" is the reference in float32,
# a witness of what float32 rounding alone gives
SOLVERS = {"reference": (torch.float64, None),
           "control": (torch.float32, torch.bfloat16),
           "plain32": (torch.float32, None)}


def solver_cast(solver: str):
    """The function that puts a state tree into `solver`'s precision: its
    dtype, through its storage dtype where it has one."""
    from .states import map_tensors
    dtype, store = SOLVERS[solver]

    def one(t):
        if not t.is_floating_point():
            return t
        return (t.to(store) if store else t).to(dtype)
    return lambda tree: map_tensors(tree, one)


def _rms(x) -> float:
    return float(torch.sqrt(torch.mean(torch.square(x.to(torch.float64)))))


def _fields(dyn) -> dict:
    out = {"u": dyn.u, "v": dyn.v, "pt": dyn.pt, "delp": dyn.delp}
    for m in range(dyn.q.shape[0]):
        out[f"q{m}"] = dyn.q[m]
    return out


def field_errors(start, program, reference) -> dict:
    """{field: error} of the program's dycore state against the
    reference's, both advanced from `start` (DynStates of either package;
    the fields are read by name)."""
    s, p, r = _fields(start), _fields(program), _fields(reference)
    errs = {}
    for name in s:
        change = _rms(r[name].to(torch.float64) - s[name].to(torch.float64))
        if change == 0.0:
            continue
        errs[name] = _rms(p[name].to(torch.float64)
                          - r[name].to(torch.float64)) / change
    return errs


def worst(errs: dict, fields="all") -> float:
    """The largest error of `fields` ("all", or a list of names), NaN if
    any is NaN or none is there."""
    vals = [v for k, v in errs.items() if fields == "all" or k in fields]
    if not vals or any(math.isnan(v) for v in vals):
        return float("nan")
    return max(vals)


def numbers(errors: dict, compared: dict) -> dict:
    """The compared numbers of a configuration's "compared" table: each
    the worst field error of its check over its fields."""
    return {name: worst(errors[c["check"]], c["fields"])
            for name, c in compared.items()}


def limits_of(compared: dict) -> dict:
    return {name: c["limit"] for name, c in compared.items()}


def verdict(numbers: dict, limits: dict) -> bool:
    """True where every number is at or below its limit (NaN is not)."""
    return all(numbers[k] <= limits[k] for k in limits)


def limit_lines(numbers: dict, limits: dict) -> list[str]:
    """The lines printed last on standard error: each number beside its
    limit."""
    return [f"compare {k}: {numbers[k]!r} limit {limits[k]!r} "
            f"{'ok' if numbers[k] <= limits[k] else 'FAIL'}" for k in limits]

