"""Periodic /metrics push to remote endpoints (reference lib/pushmetrics +
the vendored metrics.InitPush): every interval, collect the metrics text and
POST it to each -pushmetrics.url with extra labels appended.

The port's copy of ``victoriametrics_tpu/utils/pushmetrics.py``.
"""

from __future__ import annotations

import gzip
import threading
import urllib.request

from . import logger
from .metrics import REGISTRY, splice_extra_labels


class MetricsPusher:
    def __init__(self, urls: list[str], collect_fn, interval_s: float = 10.0,
                 extra_labels: str = ""):
        """collect_fn() -> prometheus text exposition string."""
        self.urls = urls
        self.collect_fn = collect_fn
        self.interval_s = interval_s
        self.extra_labels = extra_labels
        self._stop = threading.Event()
        # one long-lived push ticker per process — not fan-out work
        self._thread = threading.Thread(  # vmt: disable=VMT011
            target=self._loop, daemon=True)
        # registry-backed (reference metrics_push_total /
        # metrics_push_errors_total, vendor/.../metrics/push.go:128)
        self._pushes = REGISTRY.counter("vm_pushmetrics_pushes_total")
        self._errors = REGISTRY.counter("vm_pushmetrics_errors_total")

    @property
    def pushes(self) -> int:
        return self._pushes.get()

    @property
    def errors(self) -> int:
        return self._errors.get()

    def start(self):
        if self.urls:
            self._thread.start()

    def stop(self):
        self._stop.set()

    def _render(self) -> bytes:
        # the shared exposition splicer is quote-aware: label values with
        # spaces/braces survive (the old partition(" ") surgery did not)
        text = splice_extra_labels(self.collect_fn(), self.extra_labels)
        # gzip like the reference metrics.InitPush (push.go:167)
        return gzip.compress(text.encode(), 5)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                body = self._render()
                for url in self.urls:
                    try:
                        req = urllib.request.Request(
                            url, data=body, method="POST",
                            headers={"Content-Type": "text/plain",
                                     "Content-Encoding": "gzip"})
                        with urllib.request.urlopen(req, timeout=10):
                            self._pushes.inc()
                    except OSError as e:
                        self._errors.inc()
                        logger.throttled_warnf("pushmetrics", 30,
                                               "pushmetrics %s: %s", url, e)
            except Exception as e:  # collect_fn error must not kill the loop
                self._errors.inc()
                logger.throttled_warnf("pushmetrics-collect", 30,
                                       "pushmetrics collect: %s", e)
