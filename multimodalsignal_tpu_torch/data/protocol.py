"""WESAD protocol (quest CSV) parsing (a copy of
multimodalsignal_tpu/data/protocol.py).

Parity target: reference preprocess.py:41-58 (`parse_quest_csv`), including the
S2/S6 special case that halves the Base window by moving its start to the
midpoint (preprocess.py:53-57).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class ProtocolRow:
    task: str
    start_min: float
    end_min: float


def _parse_row(fields: list[str]) -> list[str]:
    # Drop the leading "# ORDER/START/END" marker cell, keep non-empty cells.
    # Real WESAD quest CSVs pad rows with trailing ';' separators, and some
    # exports materialize those empties as literal NaN cells — the reference
    # reads them via pandas and relies on .dropna() (preprocess.py:47-49);
    # the csv-reader equivalent must drop both forms.
    return [
        f.strip() for f in fields[1:]
        if f is not None and f.strip() != "" and f.strip().lower() != "nan"
    ]


def parse_quest_csv(subject_id: str, wesad_root: Path | str) -> list[ProtocolRow]:
    """Parse S*_quest.csv (';'-separated) into (task, start_min, end_min) rows.

    Matches reference preprocess.py:41-58: reads the `# ORDER`, `# START` and
    `# END` rows, requires equal lengths, and for subjects S2/S6 moves the Base
    start to the window midpoint.
    """
    quest_path = Path(wesad_root) / subject_id / f"{subject_id}_quest.csv"
    order = start = end = None
    with open(quest_path, newline="") as f:
        for fields in csv.reader(f, delimiter=";"):
            if not fields:
                continue
            head = fields[0]
            if "# ORDER" in head:
                order = _parse_row(fields)
            elif "# START" in head:
                start = _parse_row(fields)
            elif "# END" in head:
                end = _parse_row(fields)
    if order is None or start is None or end is None:
        raise ValueError(f"quest CSV for {subject_id} is missing ORDER/START/END rows")
    starts = [float(s) for s in start]
    ends = [float(s) for s in end]
    if not (len(order) == len(starts) == len(ends)):
        raise ValueError(
            f"Parsed task/start/end lengths mismatch for subject {subject_id}!"
        )
    rows = [ProtocolRow(t, s, e) for t, s, e in zip(order, starts, ends)]
    if subject_id in ("S2", "S6"):
        for i, row in enumerate(rows):
            if row.task == "Base":
                rows[i] = ProtocolRow(row.task, (row.start_min + row.end_min) / 2, row.end_min)
                break
    return rows
