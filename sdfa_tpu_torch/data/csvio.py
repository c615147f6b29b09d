"""Typed-column CSV manifests (counterpart of ``sdfa_tpu/data/csvio.py``, copied:
importing that module would import jax; reference: saber/data/csv/csv.py:34-93).

Column headers are ``name:type`` with types int/float/str/path; ``path``
columns are stored relative to the csv location and re-rooted on read.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

_CASTS = {"int": int, "float": float, "str": str, "path": str}


def read_csv(path: str) -> List[Dict[str, object]]:
    root = os.path.dirname(os.path.abspath(path))
    rows: List[Dict[str, object]] = []
    with open(path, newline="") as fp:
        reader = csv.reader(fp)
        header = next(reader)
        types = []
        for col in header:
            name, _, typ = col.partition(":")
            assert typ in _CASTS, f"unknown csv column type: {col}"
            types.append((col, typ))
        for rec in reader:
            row: Dict[str, object] = {}
            for (col, typ), val in zip(types, rec):
                if typ == "path":
                    val = os.path.normpath(os.path.join(root, val))
                else:
                    val = _CASTS[typ](val)
                row[col] = val
            rows.append(row)
    return rows


def write_csv(path: str, rows: List[Dict[str, object]]):
    assert rows, "cannot write empty csv"
    root = os.path.dirname(os.path.abspath(path))
    os.makedirs(root, exist_ok=True)
    header = list(rows[0].keys())
    with open(path, "w", newline="") as fp:
        writer = csv.writer(fp)
        writer.writerow(header)
        for row in rows:
            rec = []
            for col in header:
                val = row[col]
                if col.endswith(":path"):
                    val = os.path.relpath(str(val), root)
                rec.append(val)
            writer.writerow(rec)
