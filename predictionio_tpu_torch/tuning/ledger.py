"""The durable trial ledger: append-only JSONL of finished grid cells
(port of ``predictionio_tpu/tuning/ledger.py``; the two packages read each
other's ledgers).

One line per *finished* cell (scored or failed-with-error), flushed and
fsynced before the append returns — a SIGKILL between cells loses nothing,
a SIGKILL mid-append leaves at most one torn tail line, which the loader
skips. Resume is a pure set-difference: cells whose content-addressed id
already has a ledger line are never retrained.

The completed ledger's sha256 is the grid report's integrity anchor: its
scores table can be re-derived from the exact ledger that produced it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any

logger = logging.getLogger(__name__)


class TrialLedger:
    """Append-only JSONL cell records under one grid workdir."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    # ------------------------------------------------------------- read
    def load(self) -> dict[str, dict[str, Any]]:
        """Finished cells by cell id. Torn tail lines (a crash mid-append)
        are skipped with a warning; a torn line means the cell never
        finished, so skipping it is exactly the resume semantics."""
        records: dict[str, dict[str, Any]] = {}
        if not os.path.exists(self.path):
            return records
        with open(self.path, encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    cell_id = rec["cellId"]
                except (ValueError, KeyError, TypeError):
                    logger.warning(
                        "ledger %s: skipping torn/malformed line %d",
                        self.path,
                        lineno,
                    )
                    continue
                records[cell_id] = rec
        return records

    # ------------------------------------------------------------ write
    def append(self, record: dict[str, Any]) -> None:
        """Durably append one finished cell (single writer: the grid
        runner parent). flush + fsync before returning — the record
        either survives a kill or was never promised."""
        if "cellId" not in record:
            raise ValueError("ledger records need a cellId")
        if self._fh is None:
            directory = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(directory, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TrialLedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- evidence
    def sha256(self) -> str:
        """Content hash of the ledger file (empty-file hash when absent);
        computed AFTER close/flush — the evidence anchor in the winner's
        manifest."""
        digest = hashlib.sha256()
        if os.path.exists(self.path):
            with open(self.path, "rb") as fh:
                for chunk in iter(lambda: fh.read(1 << 16), b""):
                    digest.update(chunk)
        return digest.hexdigest()
