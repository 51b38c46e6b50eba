#!/bin/sh
# Static-analysis entry point of the PyTorch/CUDA port: the port's lint
# engine over victoriametrics_tpu_torch/, with its whole-program passes
# (deadline taint VMT012, lockset VMT015, error flow VMT016, stale
# disables VMT013, env flags vs README VMT014) and its wire-schema
# ratchet (devtools/wire_schema.lock.json, the reference's lock byte for
# byte).  VMT006 flags host syncs inside the CUDA kernel wrappers.  Exit
# codes: 0 clean against devtools/lint_baseline.txt (empty), 1 new
# findings, 3 stale baseline entries, 2/4 wire-schema drift/break.
# Extra args are passed to the lint, e.g.:
#   tools/lint_torch.sh --no-baseline
#   tools/lint_torch.sh --format=sarif
#
# After a clean lint the port's smokes run, each skipped by its flag as
# in tools/lint.sh: flight recorder (VMT_NO_FLIGHT_SMOKE), profiler
# (VMT_NO_PROFILE_SMOKE), matstream fan-out (VMT_NO_MATSTREAM_SMOKE),
# self-scrape (VMT_NO_SELFSCRAPE_SMOKE), reshard (VMT_NO_RESHARD_SMOKE),
# downsample (VMT_NO_DOWNSAMPLE_SMOKE) and the build cache
# (VMT_NO_COMPILE_CACHE_SMOKE: a second process on a built tree starts
# no compiler; it skips loudly, exit 0, where there is no nvcc).
set -eu
cd "$(dirname "$0")/.."
python -m victoriametrics_tpu_torch.devtools.lint "$@"
python -m victoriametrics_tpu_torch.devtools.wireschema
for smoke in flight:flight_overhead profile:profile_overhead \
             matstream:matstream_overhead selfscrape:selfscrape_overhead \
             reshard:reshard_smoke downsample:downsample_smoke \
             compile_cache:compile_cache_smoke; do
    flag="VMT_NO_$(echo "${smoke%%:*}" | tr a-z A-Z)_SMOKE"
    eval "skip=\${$flag:-0}"
    if [ "$skip" != "1" ]; then
        python -m "victoriametrics_tpu_torch.devtools.${smoke#*:}"
    fi
done
