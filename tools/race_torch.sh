#!/bin/sh
# Race-detection entry point of the PyTorch/CUDA port (tools/race.sh's
# counterpart): the port's race-marked tests with its happens-before
# sanitizer on.
#
#   VMT_RACETRACE=1   the port's vector-clock sanitizer
#                     (victoriametrics_tpu_torch/devtools/racetrace.py):
#                     traced fields in its storage, mergeset, index and
#                     RPC are checked, make_lock/make_rlock return
#                     TracedLocks, Thread start/join and queue.Queue
#                     put/get carry clocks.
#
# The selection: tests/test_torch_tracers.py (the reference's lock-order,
# sanitizer and deterministic-scheduler cases on both packages, the
# tenant gate under the scheduler, the rolling window under concurrent
# refreshes) and tests/test_torch_matstream.py's stress.  Each package's
# sanitizer is enabled by its own fixture; the env flag turns the port's
# on for the whole run.  Reports print both stacks, count into
# vm_race_reports_total and surface as RaceWarning; a failing
# interleaving replays from its seed through
# victoriametrics_tpu_torch.devtools.sched.DeterministicScheduler.
#
# The reference reads the same VMT_RACETRACE, so its copies of the cases
# (the "[ref]" ids) are left to tools/race.sh: "-k 'not ref'" keeps the
# port's ("[port]", and the cases that compare the two packages' schedules
# under each sanitizer in turn).
#
# Extra args pass through to pytest, e.g.:
#   tools/race_torch.sh -k scheduler
set -eu
cd "$(dirname "$0")/.."
exec env VMT_RACETRACE=1 VMT_LOCKTRACE_MAX_HOLD_MS=60000 \
    JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}" \
    python -m pytest tests/test_torch_tracers.py \
    tests/test_torch_matstream.py -q -m race -k "not ref" \
    -p no:cacheprovider "$@"
