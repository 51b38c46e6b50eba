"""Ingestion rate limiter (reference lib/ratelimiter/ratelimiter.go,
wired at app/vminsert/common/insert_ctx.go:286 Register(len(ctx.mrs))).

Budget-bucket semantics match the reference: the budget grows by
`per_second_limit` once per second-deadline; `register` BLOCKS while the
budget is exhausted (bursts are smoothed to the configured rate), and a
stop event unblocks waiters at shutdown. `register_bounded` additionally
gives HTTP callers a rejection path: it blocks at most `max_wait_s` and
then reports the seconds until the next refill so the handler can return
429 + Retry-After instead of pinning a connection (the reference's
vmagent remote-write client does the equivalent with its own retry
backoff).

Per-tenant limits compose with the global one through TenantRateLimiters
(lib/tenantmetrics-style lazy map).

The port's copy of ``victoriametrics_tpu/ingest/ratelimiter.py``, whole.
"""

from __future__ import annotations

import math
import threading
import time


class RateLimiter:
    """Limits per-second rate of arbitrary resources (rows)."""

    def __init__(self, per_second_limit: int, stop_event=None,
                 clock=time.monotonic):
        self.per_second_limit = int(per_second_limit)
        self._stop = stop_event if stop_event is not None \
            else threading.Event()
        self._clock = clock
        self._mu = threading.Lock()
        self._budget = 0
        self._deadline = 0.0
        self.limit_reached = 0  # vm_ingestion_rate_limit_reached_total

    def stop(self) -> None:
        """Unblock all current and future register() waiters."""
        self._stop.set()

    def register(self, count: int) -> None:
        """Consume `count` resources, blocking while over the limit."""
        self.register_bounded(count, max_wait_s=None)

    def register_bounded(self, count: int,
                         max_wait_s: float | None = 1.0) -> float:
        """Consume `count` resources. Blocks up to `max_wait_s` seconds
        (None = indefinitely, reference semantics). Returns 0.0 when the
        resources were admitted, else the suggested Retry-After seconds
        (> 0) — the caller must NOT ingest in that case."""
        limit = self.per_second_limit
        if limit <= 0 or count <= 0:
            return 0.0  # empty batches (metadata-only posts) never 429
        waited = 0.0
        with self._mu:
            while self._budget <= 0:
                if self._stop.is_set():
                    return 0.0  # shutdown: let the caller finish fast
                now = self._clock()
                d = self._deadline - now
                if d > 0:
                    self.limit_reached += 1
                    if max_wait_s is not None and waited + d > max_wait_s:
                        # seconds until enough refills cover this burst
                        deficit = -self._budget + count
                        return d + max(
                            math.ceil(deficit / limit) - 1, 0)
                    # drop the lock while sleeping so other callers fail
                    # fast instead of queueing behind the sleeper
                    self._mu.release()
                    try:
                        interrupted = self._stop.wait(d)
                    finally:
                        self._mu.acquire()
                    waited += d
                    if interrupted:
                        return 0.0
                    continue
                self._budget += limit
                self._deadline = now + 1.0
            self._budget -= int(count)
        return 0.0

    def refund(self, count: int) -> None:
        """Return resources debited for a batch that was NOT ingested
        (a later limiter in a chain rejected it) — otherwise rejected
        retries would starve everyone else's budget."""
        if self.per_second_limit <= 0 or count <= 0:
            return
        with self._mu:
            self._budget += int(count)


class RateLimitedError(Exception):
    """Raised by ingest paths when a batch is rejected; the HTTP layer
    converts it to 429 with Retry-After."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = max(1, math.ceil(retry_after_s))
        super().__init__(
            f"ingestion rate limit exceeded; retry after "
            f"{self.retry_after_s}s (see -maxIngestionRate)")


class TenantRateLimiters:
    """Global + lazily-created per-tenant limiters. `register` applies
    the global limit first (it is the capacity guard), then the tenant's
    own budget."""

    def __init__(self, global_limit: int = 0, per_tenant_limit: int = 0,
                 max_wait_s: float | None = 1.0, clock=time.monotonic):
        self._clock = clock
        self.max_wait_s = max_wait_s
        self.global_rl = (RateLimiter(global_limit, clock=clock)
                          if global_limit > 0 else None)
        self._per_tenant_limit = per_tenant_limit
        self._tenant_rls: dict[tuple, RateLimiter] = {}
        self._mu = threading.Lock()

    def enabled(self) -> bool:
        return self.global_rl is not None or self._per_tenant_limit > 0

    def _tenant_rl(self, tenant) -> RateLimiter | None:
        if self._per_tenant_limit <= 0:
            return None
        # racy-by-design fast path: a stale miss just falls through to
        # the locked setdefault, which both racers resolve to ONE limiter
        rl = self._tenant_rls.get(tenant)  # vmt: disable=VMT015
        if rl is None:
            with self._mu:
                rl = self._tenant_rls.setdefault(
                    tenant,
                    RateLimiter(self._per_tenant_limit, clock=self._clock))
        return rl

    def register(self, count: int, tenant=(0, 0)) -> None:
        """Admit `count` rows or raise RateLimitedError. The tenant's own
        (narrower) budget is checked FIRST and refunded if the global
        limiter then rejects — a saturated tenant's retries must not
        drain the global budget and starve other tenants."""
        tenant_rl = self._tenant_rl(tenant)
        if tenant_rl is not None:
            retry = tenant_rl.register_bounded(count, self.max_wait_s)
            if retry > 0:
                raise RateLimitedError(retry)
        if self.global_rl is not None:
            retry = self.global_rl.register_bounded(count, self.max_wait_s)
            if retry > 0:
                if tenant_rl is not None:
                    tenant_rl.refund(count)
                raise RateLimitedError(retry)

    def stop(self) -> None:
        if self.global_rl is not None:
            self.global_rl.stop()
        for rl in self._tenant_rls.values():
            rl.stop()
