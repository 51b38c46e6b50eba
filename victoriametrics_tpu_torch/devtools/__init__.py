"""Development seams the storage fires through: the fault injector
(:mod:`faultinject`, the crash and delay seams of the chaos suite) and the
lock and field factories of the lock-order tracer and the race sanitizer
(:mod:`locktrace`, :mod:`racetrace`), which return the plain objects while
tracing is off.  The tracers themselves and the lint come with the
tooling item of the roadmap."""
