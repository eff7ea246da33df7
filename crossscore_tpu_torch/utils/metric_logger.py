"""Bounded append-only metric caches computed lazily; the port's own copy of
``crossscore_tpu/utils/metric_logger.py`` (reference
``utils/evaluation/metric_logger.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


class MetricLogger:
    def __init__(self, max_length: Optional[int] = None):
        self.storage: list = []
        self.max_length = max_length

    def update(self, x):
        if self.max_length is not None and len(self) >= self.max_length:
            self.reset()
        self.storage.append(np.asarray(x))

    def reset(self):
        self.storage.clear()

    def __len__(self):
        return len(self.storage)


class MetricLoggerScalar(MetricLogger):
    def compute(self, aggregation_fn=np.mean):
        return float(aggregation_fn(np.stack(self.storage)))
