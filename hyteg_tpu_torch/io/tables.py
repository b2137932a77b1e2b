"""Tabular metric sinks: SQLite DB, LaTeX key-value store, and tables
(torch counterpart of hyteg_tpu/io/tables.py, on the standard library's
sqlite3).

Reference: src/hyteg/dataexport/SQL.hpp:37 (FixedSizeSQLDB with constant +
variable columns per row), KeyValueStore.hpp:57, Table.hpp:71 (LaTeX
export, golden-file tested by tests/hyteg/dataexport+import/TableTest.cpp).

FixedSizeSQLDB stores a 0-d tensor or a numpy scalar as its Python value
(``.item()``), so a float32 residual lands in a REAL column; the JAX
package stores any value that is not a Python int, float or bool as text
(ROADMAP C-ref19). The text and LaTeX tables print a 0-d tensor as its
Python value and anything else as the JAX package does.
"""

from __future__ import annotations

import sqlite3
from typing import Any

import numpy as np
import torch


def plain_value(v, numpy_scalars: bool = True):
    """A 0-d tensor (and, with ``numpy_scalars``, a numpy scalar) as its
    Python value; anything else as it is."""
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        return v.item()
    if numpy_scalars and isinstance(v, np.generic):
        return v.item()
    return v


class FixedSizeSQLDB:
    """Rows = constant entries (set once) + variable entries (per row),
    written to an SQLite table (reference: FixedSizeSQLDB)."""

    def __init__(self, path: str, table: str = "runs"):
        self.path = path
        self.table = table
        self._const: dict[str, Any] = {}
        self._var: dict[str, Any] = {}
        self._columns: list[str] | None = None

    def set_constant_entry(self, key: str, value) -> None:
        self._const[key] = plain_value(value)

    def set_variable_entry(self, key: str, value) -> None:
        self._var[key] = plain_value(value)

    def _sql_type(self, v) -> str:
        if isinstance(v, bool):
            return "INTEGER"
        if isinstance(v, int):
            return "INTEGER"
        if isinstance(v, float):
            return "REAL"
        return "TEXT"

    def write_row_on_root(self) -> None:
        """Commit one row (reference: writeRowOnRoot)."""
        row = {**self._const, **self._var}
        cols = sorted(row)
        if self._columns is None:
            self._columns = cols
            with sqlite3.connect(self.path) as db:
                spec = ", ".join(f'"{c}" {self._sql_type(row[c])}'
                                 for c in cols)
                db.execute(f'CREATE TABLE IF NOT EXISTS {self.table} ({spec})')
        if cols != self._columns:
            raise ValueError(
                f"row schema changed: {cols} != {self._columns}")
        with sqlite3.connect(self.path) as db:
            ph = ", ".join("?" for _ in cols)
            names = ", ".join(f'"{c}"' for c in cols)
            db.execute(
                f"INSERT INTO {self.table} ({names}) VALUES ({ph})",
                [row[c] if isinstance(row[c], (int, float, bool)) else str(row[c])
                 for c in cols],
            )


class KeyValueStore:
    """Ordered key-value pairs with LaTeX export
    (reference: KeyValueStore.hpp:57 — \\pgfkeys output)."""

    def __init__(self):
        self._store: dict[str, Any] = {}

    def store(self, key: str, value) -> None:
        self._store[key] = plain_value(value, numpy_scalars=False)

    def __getitem__(self, key):
        return self._store[key]

    def write_latex(self, path: str, prefix: str = "") -> None:
        with open(path, "w") as f:
            f.write("\\pgfkeys{\n")
            for k, v in self._store.items():
                f.write(f"  {prefix}{k}/.initial = {{{v}}},\n")
            f.write("}\n")

    def __str__(self) -> str:
        w = max((len(k) for k in self._store), default=0)
        return "\n".join(f"{k:<{w}}  {v}" for k, v in self._store.items())


class Table:
    """Fixed-column table with aligned text and LaTeX (booktabs) export
    (reference: Table.hpp:71)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.rows: list[list[Any]] = []

    def add_row(self, *values) -> None:
        if len(values) != len(self.columns):
            raise ValueError(f"expected {len(self.columns)} values")
        self.rows.append([plain_value(v, numpy_scalars=False)
                          for v in values])

    def add_element(self, row: int, col: str, value) -> None:
        while len(self.rows) <= row:
            self.rows.append([""] * len(self.columns))
        self.rows[row][self.columns.index(col)] = plain_value(
            value, numpy_scalars=False)

    def __str__(self) -> str:
        cells = [self.columns] + [[str(v) for v in r] for r in self.rows]
        widths = [max(len(r[c]) for r in cells)
                  for c in range(len(self.columns))]
        lines = []
        for r in cells:
            lines.append("  ".join(f"{v:<{w}}" for v, w in zip(r, widths)))
        return "\n".join(lines)

    def write_text(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(str(self) + "\n")

    def write_latex(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\\begin{tabular}{" + "c" * len(self.columns) + "}\n")
            f.write("\\toprule\n")
            f.write(" & ".join(self.columns) + " \\\\\n\\midrule\n")
            for r in self.rows:
                f.write(" & ".join(str(v) for v in r) + " \\\\\n")
            f.write("\\bottomrule\n\\end{tabular}\n")
