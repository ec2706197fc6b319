"""The trainer's metrics stream: one JSON object a line.

Counterpart of `MetricsLogger` (`mmada_tpu/utils/logging.py:19-56`) without
its optional TensorBoard writer (TensorFlow is not a dependency of the
port): each `log` appends `{"time": ..., **metrics}` to `path`, line
buffered, so a killed run keeps every line it logged.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def log(self, metrics: dict[str, Any], step: Optional[int] = None):
        record = {"time": time.time(), **metrics}
        if step is not None:
            record["step"] = step
        self._fh.write(json.dumps(record) + "\n")

    def close(self):
        self._fh.close()
