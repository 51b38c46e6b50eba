"""SeriesData: one decoded series as a storage search returns it.

The port's copy of ``victoriametrics_tpu/storage/storage.py:SeriesData``,
the per-series shape the cold device query consumes.  ``metric_name`` is
opaque to the device engine; ``raw_name`` (the marshaled name) keys tile
fingerprints and rolling-tile rows.
"""

from __future__ import annotations

import numpy as np


class SeriesData:
    """Decoded query result for one series."""

    __slots__ = ("metric_name", "timestamps", "values", "raw_name")

    def __init__(self, metric_name, timestamps: np.ndarray,
                 values: np.ndarray, raw_name: bytes | None = None):
        self.metric_name = metric_name
        self.timestamps = timestamps
        self.values = values
        self.raw_name = raw_name
