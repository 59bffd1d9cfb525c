"""Validation-table formatting (the port's copy of
`mod_extraction_tpu/evaluation/tables.py`).

The archived `eval/*.txt` tables are Lightning's box-drawn validate tables;
both packages write them byte for byte alike, so a table of either can be
diffed against the archive row by row.
"""

from __future__ import annotations

from typing import Dict


def format_validate_table(metrics: Dict[str, float]) -> str:
    """Render the Lightning-style validate-metric table."""
    col1, col2 = "Validate metric", "DataLoader 0"
    rows = sorted(metrics.items())
    w1 = max(len(col1), *(len(k) for k, _ in rows)) + 12
    w2 = max(len(col2), *(len(f"{v!r}") for _, v in rows)) + 12
    w1 = max(w1, 27)
    w2 = max(w2, 27)
    lines = [
        "┏" + "━" * w1 + "┳" + "━" * w2 + "┓",
        "┃" + col1.center(w1) + "┃" + col2.center(w2) + "┃",
        "┡" + "━" * w1 + "╇" + "━" * w2 + "┩",
    ]
    for k, v in rows:
        lines.append("│" + k.center(w1) + "│" + str(float(v)).center(w2) + "│")
    lines.append("└" + "─" * w1 + "┴" + "─" * w2 + "┘")
    return "\n".join(lines)


def format_eval_block(metrics: Dict[str, float], label: str) -> str:
    """Table + the `=== label ===` banner used in `eval/*.txt`."""
    sep = "=" * 65
    return f"{format_validate_table(metrics)}\n{sep}\n{label}\n{sep}\n"
