"""Metrics logging: TensorBoard + JSONL.

Counterpart of ``gmf_tpu/utils/logging_utils.py``. The reference logs
every trainer metric to tensorboardX (libs/trainer.py:30,178-181,267-268;
core/trainer.py:75,128-129,334-335). The JSONL stream
(``<log_dir>/metrics.jsonl``) is always written; the TensorBoard writer
joins it only where ``tensorboardX`` imports (the optional import guards a
log sink, not a device or a kernel).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 use_tensorboard: bool = True):
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(log_dir=log_dir)
                except Exception:
                    self._tb = None

    def log(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        tag = (prefix + "/") if prefix else ""
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(f"{tag}{k}", float(v), step)
                except (TypeError, ValueError):
                    pass
        if self._jsonl is not None:
            row = {"step": step, "time": time.time(), "prefix": prefix}
            row.update({k: float(v) for k, v in metrics.items()
                        if isinstance(v, (int, float))})
            self._jsonl.write(json.dumps(row) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
