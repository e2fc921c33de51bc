"""What the span metrics read: a span's device time a step in the
window (the record's "spans", harness/spans.table, which
tools/span_table.py adds; a record without it reads None)."""

from __future__ import annotations


def per_step_ms(record: dict, span: str, key: str) -> float | None:
    """`key` (seconds) of `span`'s row in ms a step; None where the
    program marked no such span or the window holds no step."""
    row = record.get("spans", {}).get(span)
    if row is None or not record["steps"]:
        return None
    return 1e3 * row[key] / record["steps"]
