"""Metrics logging with reference-compatible series names.

Copy of ``feddrift_tpu/utils/metrics.py::MetricsLogger`` without its wandb
mirror: the same series (Train/Acc, Test/Acc, Train/Loss, Test/Loss,
per-client ``*-CL-{c}``, ``Plurality/CL-{c}``) flow to an in-memory history
and to ``<out_dir>/metrics.jsonl``, one JSON object per line with ``_ts``,
``round`` and ``iteration``, and summaries (num_models, local_models,
Contribute/CL-{c}, Merge) to ``summary``. The logger is a context manager
and ``close()`` is idempotent.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

log = logging.getLogger("feddrift_torch")


class MetricsLogger:
    def __init__(self, out_dir: str | None = None) -> None:
        self.history: list[dict[str, Any]] = []
        self.summary: dict[str, Any] = {}
        self._fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, "metrics.jsonl"), "a")

    def log(self, metrics: dict[str, Any]) -> None:
        rec = {"_ts": time.time(), **metrics}
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def set_summary(self, key: str, value: Any) -> None:
        self.summary[key] = value

    def series(self, name: str) -> list[tuple[int, Any]]:
        """(round, value) pairs for one metric name."""
        return [(r.get("round", i), r[name])
                for i, r in enumerate(self.history) if name in r]

    def last(self, name: str, default=None):
        s = self.series(name)
        return s[-1][1] if s else default

    def truncate_from(self, iteration: int) -> None:
        """Drop rows whose ``iteration`` is >= the given value, in the JSONL
        file and in memory (on resume: the iteration about to re-run may
        have logged part of itself after the last checkpoint)."""
        self.history = [r for r in self.history
                        if r.get("iteration", -1) < iteration]
        if not self._fh:
            return
        path = self._fh.name
        self._fh.close()
        kept = []
        try:
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("iteration", -1) < iteration:
                        kept.append(line if line.endswith("\n")
                                    else line + "\n")
        except OSError as exc:
            # leave the file as it is rather than rewrite it from an empty
            # `kept`: duplicated partial rows are recoverable, an emptied
            # history is not
            log.warning("metrics truncation read-back failed (%s): %s left "
                        "untouched; rows with iteration >= %d may repeat",
                        exc, path, iteration)
            self._fh = open(path, "a")
            return
        with open(path, "w") as f:
            f.writelines(kept)
        self._fh = open(path, "a")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
