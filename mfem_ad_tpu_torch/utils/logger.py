"""TableLogger: columnar iteration logging with optional CSV mirroring.

PyTorch counterpart of ``mfem_ad_tpu.utils.logger`` (after MFEM-AD's
TableLogger): register named value *getters* (or mutable dicts), print
aligned rows, optionally mirror every printed row to a CSV file.  In a
``torch.distributed`` run only rank 0 prints.
"""

from __future__ import annotations

import os
from typing import Callable

import torch


def _is_root() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` group, or a process
    outside any group."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return True
    return dist.get_rank() == 0


class TableLogger:
    def __init__(self, width: int = 14, precision: int = 6):
        self.width = width
        self.precision = precision
        self._cols: list[tuple[str, Callable[[], object]]] = []
        self._csv_path: str | None = None
        self._csv_file = None
        self._printed_header = False
        self._root = _is_root()

    def append(self, name: str, getter) -> "TableLogger":
        """Register a column: getter is a callable or a (dict, key) pair."""
        if isinstance(getter, tuple):
            d, k = getter
            getter = lambda: d[k]  # noqa: E731
        elif not callable(getter):
            raise TypeError("getter must be callable or (dict, key)")
        self._cols.append((name, getter))
        return self

    def save_when_print(self, path: str) -> "TableLogger":
        """Mirror printed rows into a CSV file."""
        self._csv_path = path
        return self

    def _fmt(self, v) -> str:
        if isinstance(v, float):
            return f"{v:{self.width}.{self.precision}e}"
        return f"{v!s:>{self.width}}"

    def print(self):
        if not self._root:
            return
        if not self._printed_header:
            header = "".join(f"{n:>{self.width}}" for n, _ in self._cols)
            print(header)
            print("-" * len(header))
            self._printed_header = True
            if self._csv_path:
                os.makedirs(
                    os.path.dirname(os.path.abspath(self._csv_path)),
                    exist_ok=True,
                )
                self._csv_file = open(self._csv_path, "w")
                self._csv_file.write(
                    ",".join(n for n, _ in self._cols) + "\n"
                )
        vals = [g() for _, g in self._cols]
        print("".join(self._fmt(v) for v in vals))
        if self._csv_file:
            self._csv_file.write(",".join(str(v) for v in vals) + "\n")
            self._csv_file.flush()

    def close(self):
        if self._csv_file:
            self._csv_file.close()
            self._csv_file = None
