"""Structured metric logging (JAX package `utils/logging.py:MetricLogger`):
one JSON object per log call, appended to a JSONL file and echoed to
stderr, with the seconds since the logger started under "t"."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict


class MetricLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, **metrics: Any) -> Dict[str, Any]:
        rec = {"t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        line = json.dumps(rec)
        self._fh.write(line + "\n")
        print(line, file=sys.stderr)
        return rec

    def close(self) -> None:
        self._fh.close()
