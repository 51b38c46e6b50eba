"""Static-analysis & race-detection suite for the port (the role
`go vet` + `-race` play in the reference repo).

- :mod:`lint` — an AST lint engine with project-specific rules
  (VMT001..VMT011) covering deterministic-time discipline, classic
  Python foot-guns, lock discipline, host syncs inside the CUDA kernel
  wrappers (:mod:`rules_torch`, VMT006), metrics-registry discipline,
  and thread/queue lifecycle, plus the whole-program passes over
  :mod:`callgraph` (:mod:`deadline_taint` VMT012, :mod:`lockset`
  VMT015, :mod:`errorflow` VMT016), the stale-disable and env-flag
  checks (VMT013, VMT014) and the wire-schema ratchet
  (:mod:`wireschema`, ``wire_schema.lock.json``); :mod:`sarif` renders
  findings as SARIF 2.1.0.  Run as
  ``python -m victoriametrics_tpu_torch.devtools.lint``.  The
  grandfather baseline ratchets both ways: new findings fail (exit 1),
  stale grandfathered entries fail distinctly (exit 3).
- :mod:`locktrace` — a runtime lock-order tracer: ``TracedLock`` is a
  drop-in for ``threading.Lock``/``RLock`` that records the per-thread
  lock-acquisition graph and fails fast on cycles (potential deadlock).
  Enabled by running any entry point with ``VMT_LOCKTRACE=1``; findings
  are counted as ``vm_locktrace_*`` registry metrics.
- :mod:`racetrace` — a FastTrack-style happens-before sanitizer:
  vector clocks synchronized at the ``make_lock`` seam, Thread
  start/join, and queue put/get; unsynchronized access pairs to
  ``traced_fields``-declared storage/RPC state are reported with both
  stacks and counted as ``vm_race_reports_total``.  Enabled with
  ``VMT_RACETRACE=1`` (zero cost when unset); ``tools/race_torch.sh``
  runs the port's race-marked tests under it.
- :mod:`sched` — a seeded deterministic cooperative scheduler (simple
  PCT) preempting at racetrace's traced points, so the interleaving
  that produced a race report is replayed from its seed.
- :mod:`faultinject` — the crash and delay seams of the chaos suite.
- The smokes: :mod:`flight_overhead`, :mod:`profile_overhead`,
  :mod:`matstream_overhead`, :mod:`selfscrape_overhead`,
  :mod:`downsample_smoke`, :mod:`reshard_smoke` and the build-cache
  smoke :mod:`compile_cache_smoke`.

The port's copy of ``victoriametrics_tpu/devtools/``.
"""
