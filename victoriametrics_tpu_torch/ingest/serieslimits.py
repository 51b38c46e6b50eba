"""Per-series cardinality/shape limits applied at ingestion (reference
lib/timeserieslimits/timeseries_limits.go:34-134): series exceeding the
limits are dropped (counted, throttled-logged), protecting the index from
malformed or abusive payloads.

The port's copy of ``victoriametrics_tpu/ingest/serieslimits.py``,
whole.
"""

from __future__ import annotations

from ..utils import logger


class SeriesLimits:
    def __init__(self, max_labels_per_series: int = 40,
                 max_label_name_len: int = 256,
                 max_label_value_len: int = 4 * 1024):
        self.max_labels = max_labels_per_series
        self.max_name_len = max_label_name_len
        self.max_value_len = max_label_value_len
        self.dropped_labels_limit = 0
        self.dropped_name_len = 0
        self.dropped_value_len = 0

    def check(self, labels: dict) -> bool:
        """True if the series passes; False = drop (with throttled log).
        A limit <= 0 disables that check (reference semantics)."""
        if self.max_labels > 0 and len(labels) > self.max_labels:
            self.dropped_labels_limit += 1
            logger.throttled_warnf(
                "serieslimit-count", 5,
                "dropping series with %d labels (limit %d)",
                len(labels), self.max_labels)
            return False
        for k, v in labels.items():
            if self.max_name_len > 0 and len(k) > self.max_name_len:
                self.dropped_name_len += 1
                logger.throttled_warnf(
                    "serieslimit-name", 5,
                    "dropping series with %d-byte label name (limit %d)",
                    len(k), self.max_name_len)
                return False
            if self.max_value_len > 0 and len(str(v)) > self.max_value_len:
                self.dropped_value_len += 1
                logger.throttled_warnf(
                    "serieslimit-value", 5,
                    "dropping series with %d-byte label value (limit %d)",
                    len(str(v)), self.max_value_len)
                return False
        return True

    def metrics(self) -> dict:
        # labeled form matches the reference's vm_rows_ignored_total{reason}
        return {
            'vm_rows_ignored_total{reason="too_many_labels"}':
                self.dropped_labels_limit,
            'vm_rows_ignored_total{reason="too_long_label_name"}':
                self.dropped_name_len,
            'vm_rows_ignored_total{reason="too_long_label_value"}':
                self.dropped_value_len,
        }
