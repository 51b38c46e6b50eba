#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device query engine on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--full-hours H]

Runs only the port (``victoriametrics_tpu_torch``), never JAX.  Phases,
each printing one JSON line:

  build       compile csrc/*.cu with nvcc for sm_90a, one process per
              source, all started together, then native/codec.cpp with
              g++ (the host codec the cold upload converts with)
  tooling     (a) devtools/compile_cache_smoke on the tree just built:
              two cold processes, each loading every kernel library and
              the native one and launching K3 once, neither starting the
              compiler; (b) the port's vmsingle as a process with the
              default backend (the card) under VMT_LOCKTRACE=warn and
              VMT_RACETRACE=1 on a fresh directory: 1024 dashboard-shaped
              counters x 1 h at 15 s over /api/v1/write, then for about
              10 s (on until K1's, K2's and K3's counters moved) 4
              clients alternating the sum panel with nocache=1 and its
              plain repeat on a window slid to the newest scrape, a writer
              (one scrape each 250 ms) and /internal/force_flush each 2 s;
              every answer whole; from /metrics no lock-order cycle and no
              race report (their counters at 0) and K1's, K2's and K3's
              device counters moved; the sum panel after the writers stop
              within rtol 1e-12 of the host evaluator's one-by-one group
              sum on the same store, read after the server's SIGTERM
  kernels     K1 decode_tiles (also at its edge rows: n of 1, 2 and odd
              widths, each d2 width, planes wider than n - 2 or at an
              offset from a 16-byte word, count-0 rows, wrapping tails,
              rows cut in chunks), K2
              rollup_aggregate_tile, K3 append_tile,
              K4 compact_tile, B5 rollup_tile, B6 topk_select_tile and
              take_rows, B7 rank_tile and B8 rollup_quantile_tile against
              their plain PyTorch versions on the card: every rollup func
              (K2 under every aggregate) on ragged edge-case rows and the
              dashboard tile, shifted and not, B5 on its plan's path
              (staged) also against its global search bit for bit; B6 at
              k in {1, 10, 16, 17,
              K_REG, K_REG + 1, S} (both of its paths and their
              boundaries) on the dashboard, ragged, tie and tall tiles,
              take_rows with int32 and int64 indices (out-of-range ones
              among them), every rank kind (and a tile wider than the
              kernels' shared-memory staging, and B7's edge rows at step
              counts on and around each median path's limits: no live
              step, one, two, ties straddling the median, signed zeros
              at j0 and j1, infinities, constant rows), every quantile
              phi at
              groups of 32 and of all rows, on rates and on a tile of
              ties, and on B8's cluster and block paths at their edges
              (one group of 100,000 rows, groups at and above what a
              cluster and a block stage, one that no cluster divides,
              an all-NaN group and one with a single live row); times
              each with CUDA events beside its plain version
              and, where one PyTorch call computes the same function, that
              call (B6 and take_rows and their library calls three ways:
              events around one call, around back-to-back calls, and the
              wrapper's host time; B8 and torch.nanquantile also so, and
              K2 over one group of the dashboard tile); K2's count,
              group, min and max of rate (with resets too) and deriv,
              plain and rolling, equal to B5's rows under the plain
              aggregate; K2 over one group of the dashboard tile and over
              groups of exactly R, R + 1 and 2R + 1 members (R =
              FLEET_CHUNK), every aggregate (count, group, min and max
              against B5's rows, the rest against the chunked plain
              version); B9
              fleet_rollup_aggregate_tile, B10
              fleet_append_tile (at K 8, 16 and 24 and at the resume's
              K 120) and
              B11 fleet_compact_tile at a fleet
              bucket's shape (nine live streams of the dashboard tile with
              their own shifts, fetch bounds and the eight aggregates
              mixed, three padded slots, padded rows and groups), B9 also
              over groups it walks in chunks, its count, group, min and
              max against K2 on each stream bit for bit (whether the
              other aggregates come out bit for bit too is recorded);
              B12
              decode_and_rollup (every func, shared-memory and scratch
              rows), B13
              sharded_rollup_aggregate (every func and aggregate on 8
              logical shards, by instance and in one group; its moments
              bit for bit against a sequential walk of B5's rows, the
              8 shards one launch), B14 cached_fleet_rollup_aggregate (both
              fleet buckets, bit for bit against B9) and B15
              time_sharded_rollup (every func but lifetime, and at a halo
              as wide as a shard, with gaps in the first time shard and in
              a halo; its halo pass row by row against the plain
              compaction, rows read in place and compacted rows both;
              one launch per phase for the card's 8 shards and at most
              one host sync), each against its plain version and against
              the unsharded kernels
  dashboard   the main path on the port's Storage
              (victoriametrics_tpu_torch/storage, in a temporary directory
              removed at the end): the seeded 8192 counters x 6 h at 15 s
              (256 instances) go in through Storage.add_rows_columnar
              (native.ColumnarRows batches of raw series keys), 40 whole
              scrapes a call; the store is closed, copied for the mesh
              phase's replay and reopened, and its columns are held
              against the seeded ones exactly before any query; a cold
              ``sum by (instance)(rate(m[5m]))`` (step 60 s) from
              store.search_series with a metric-name TagFilter, groups by
              each returned series' instance label, held bit for bit
              against K2 on the seeded series handed straight to the
              engine (in the store's row order), then the other panels on
              its resident tile (per-series
              rate, topk/bottomk(10), topk_avg/median/last(10),
              quantile(0.9) by instance, median without by), each held
              against the same entry point on a CPU engine; then 6
              rolling refreshes through advance_rolling and
              run_fused_on_tiles with new scrapes ingested in between
              through add_rows, read by advance_rolling from the store's
              data_version, min_appended_since and search_columns (one
              refresh resumes after a long pause and slides the
              window with compact_window), each followed by the quantile
              panel through run_quantile_on_tiles; every refresh is held
              against a cold rebuild at rtol 1e-12.  evaluator: each
              panel's query text (sum by (instance), rate, topk, bottomk,
              topk_avg/median/last, quantile(0.9) by instance, median)
              through the port's exec_query on the store and grid, first
              on a fresh CUDAEngine (each panel must launch its route's
              kernels: K1 + K2 for the sum, B5 for rate, B5 + B6 +
              take_rows, B5 + B7 + take_rows, B5 + B8), then through the
              port's host evaluator (tpu=None) as the oracle: sums and
              rates at rtol 1e-12, the selections' series the same and
              their values at 1e-12, quantile and median at rtol 1e-6,
              atol 1e-6; the sum again unchanged takes the warm path (one
              K2, no K1, no store fetch), its cost split beside the cold
              one's (evaluator_cost).  After each refresh the sum and
              the quantile panel through exec_query on the evaluator's
              own rolling window (the route from its trace: the ring's
              tail, a pure shift, a full grid on the advanced tile; never
              a rebuild, and a one-scrape refresh appends with K3), each
              held at rtol 1e-12 against the direct path's served result
              and a cold exec_query with disable_cache
  fleet       fleet-batched serving on the dashboard's Storage (each
              interval's scrapes through add_rows) and resident selector:
              64 standing queries (a "cut" line: 128 planned, with
              increase and irate), each given only as query text that the
              fleet parses (its window filed under the key the fleet's
              own analysis derives; the phase fails when that is not the
              resident selector's) ({rate, max_over_time} x the 8
              aggregates x {by instance, no grouping} x two grids)
              adopted into 8 buckets (the
              dashboard's sum by (instance) on grid A filed by a cold
              exec_query, the others by register_window), then six
              intervals through FleetPlane.run (one B9 launch per bucket,
              B10 appends, B11 slides at a 30-minute resume), every
              stream of every interval held against the per-stream path
              (advance_rolling + run_fused_on_tiles) at rtol 1e-12, and
              every stream's text evaluated by exec_query right after
              the run: a fleet.take hit each (no launch, no store fetch),
              its rows the plane's result table's bit for bit
  http        the port's vmsingle (apps.vmsingle build(parse_flags(...))
              with no backend flag, on a copy of the dashboard's store
              directory taken with the replay's) over localhost TCP: the
              default attach (probe subprocess, CUDAEngine, warm-up, all
              before build returns) must give the
              server the engine; the nine panels over GET
              /api/v1/query_range on the dashboard's grid, each launching
              its route's kernels, equal as strings to exec_query on the
              same EvalConfig in-process and within the evaluator check's
              bounds of the host evaluator, with its round trip and the
              server's cost split (the slow-query log's record); the sum
              again (its resident window's warm path: one K2, no K1, no
              fetch) and topk again (a full hit of the rollup result
              cache: no launch, no fetch); two refreshes, one scrape of
              every series through POST /api/v1/write (remote write,
              snappy, taking the server's native columnar branch) each,
              the sum on the grid advanced one step (K3, no K1) at rtol
              1e-12 against nocache=1 and the host evaluator;
              two instant queries (GET /api/v1/query: quantile by
              instance, B5 + B8; topk, B5 + B6 + take_rows); eight
              standing queries (rate by instance under every aggregate,
              one bucket) subscribed through the server's registry and
              pumped three intervals pinned to the data's clock, the
              scrapes through /api/v1/write (from the second interval
              one B9 launch per bucket, B10 appends, every stream
              served; each stream's reassembled frames equal its polled
              query_range, and after the last interval the host
              evaluator's rows at the fleet's bounds); an SSE
              /api/v1/watch snapshot over 256 series written through
              /api/v1/import equal to its poll; /metrics' device counters
              moved and /api/v1/status/top_queries listing the panels
  satellites  the port's vmsingle reopened on the http phase's store,
              started as a user starts it (no backend flag: build waits
              for the card's attach, and fails without it) with -rule (a
              JSON rule file: instance:m:rate5m = sum by
              (instance)(rate(m[5m])), the same expression recorded again,
              and an alert on it with for: 1m at the median instance's
              rate) and -graphiteListenAddr: (a) the group's loop stopped,
              three instants pinned to the data's clock (the last scrape,
              one and two steps on, a scrape of every series through
              /api/v1/write before each later one): 3 rules, 2
              evaluations an instant (instant_evals +2, instant_reuse +1),
              each evaluation launching K2 on the card and the first also
              K1, the shared rule nothing; the rows within rtol 1e-12 of
              the host evaluator; the alert pending, then firing;
              /api/v1/query reading back 256 series, ALERTS and
              ALERTS_FOR_STATE in the store, /api/v1/rules; (b) the
              standalone vmalert (apps.vmalert) polling the server over
              HTTP, writing to it and notifying an Alertmanager stub of
              this process: its rows the server-side group's bit for bit,
              the stub receiving the firing alerts; (c) vmagent
              (apps.vmagent) scraping a Prometheus-text target of this
              process (the next two scrapes of the 8192 series) and
              remote-writing through its persistent queue and a relay of
              this process, the relay stopped for the second scrape (the
              block queued, then delivered): every row in the store by
              name and value; (d) Graphite: three /render requests
              (sumSeries and perSecond of one instance's seriesByTag,
              groupByTags by instance over all 8192 series) over the last
              hour at 60 s, each equal to a numpy version of the render's
              last-value-in-bucket rule on the written values;
              /metrics/find, /tags, and a plaintext line through the
              listener rendered back; the server goes on serving for:
  operations  vmauth, vmbackup/vmrestore and vmctl around that server S,
              each app a process (python -m ...apps.<app>) as users run
              them: (a) vmauth with a JSON -auth.config (a basic-auth
              user, a bearer token, a JWT user with an HS256 secret and a
              required claim) routing /api/v1/query_range and
              /api/v1/query to S: the dashboard's sum panel through each
              user equal as strings to the direct request, at the
              direct request's launches (also with nocache=1: K2 each);
              a wrong password and a JWT with the wrong claim 401; (b)
              vmbackup of S through its /snapshot/create to fs:// (the
              8192 series and all S holds), a second run of the same
              snapshot uploading nothing, main_restore into a new
              directory and vmsingle D started there with the default
              backend (the phase's one attach): D's cold sum panel (K1 +
              K2) equal as strings to S's nocache=1 answer, 8192 series on
              both; (c) one more steady scrape of the 8192 series written
              to S, vmctl vm-native from S to D filtered from that scrape
              (exactly 8192 rows): the sum panel on a grid ending at it on
              D, through D's window (K3 + K2) at rtol 1e-12 of S's
              nocache=1 answer and with nocache=1 (K1 + K2) equal as
              strings; (d) one Prometheus TSDB block written by the
              port's promtsdb (the 256 series of host-0..host-7 renamed
              tsdb_requests_total, the seeded history's last hour: 61,440
              samples), vmctl verify-block ok, vmctl prometheus-tsdb into
              D: its sum by instance of rate on D (K1 + K2) within rtol
              1e-12 of S's over the same series and hour
  full_width  BASELINE config 2: 100,000 counters at 15 s, 32 series
              per instance, step 15 s, window 5 m, its history cut from
              24 h to FULL_HOURS (a "cut" line), as one cold query with
              its own launch counts (its hours of series are handed to
              the engine from memory; the ingest phase writes the first
              of those hours to a store); K1 and K2
              are checked
              against their plain versions in row chunks (K1's device ms
              on the query's planes recorded), and K2's count,
              group, min and max of rate and deriv against B5's rows
              under the plain aggregate; B5's staged rate, deriv and
              tlast_over_time against its global search bit for bit, in
              row chunks, both paths timed; then, on the
              resident tile, topk(10, rate), topk_median(10, rate),
              avg by (instance)(deriv) and an instant quantile(0.99, rate)
              over every series, each with its launch counts and checked
              against the plain versions (B8's instant at every phi on its
              cluster path, timed three ways beside torch.nanquantile;
              B6 also at k = 20 and, its sort
              path, at K_REG + 1 on a 512-step slice; B7's five kinds in
              row chunks, avg beside torch.nanmean); the library calls
              beside B6-B8 (torch.topk, torch.index_select,
              torch.nanquantile) at this width; a range quantile at this
              width is declined by the dense-budget gate, as in the
              reference
  host_codec  the cold upload's host half: the native codec
              (native/codec.cpp, built by g++) must load; the grouped
              float->decimal (``cuda_engine.decimal_columns``) and the flat
              pack (``pack_columns``) timed (f2d_ms, pack_ms) on the
              dashboard's 8192 x 1440 series beside the per-series path
              (planes_for, per_series_ms) and on the full width's 100,000
              series; mantissas and exponents bit for bit against
              float_to_decimal on each series, the planes bit for bit
              against planes_for (the dashboard and a small store of
              decimal counters and gauges with series of 1-8 samples),
              none on both paths for a store of full-precision floats and
              NaN/+-Inf/stale markers, and at full width against the
              planes K1 decoded; the block codecs (marshal_int64_array,
              marshal_timestamps, marshal_values) through the native
              codec and numpy: the same bytes, exact round trips
  ingest      the ingestion layer: (a) the native library (codec.cpp,
              parse.cpp and ingest.cpp, built by g++) must load, and its
              snappy decoder and each columnar parser (remote write,
              Prometheus text, Influx lines) must return the whole batch
              of the phase's own bodies; (b) the port's vmsingle on a
              store of the phase's own (-search.tpuBackend=false: it
              answers no query): the dashboard's 8192 series as a
              snappy remote-write body to /api/v1/write, Prometheus text
              to /api/v1/import/prometheus and Influx lines to
              /influx/write, each under its own metric name, first one
              scrape (every key new) and then 4 (every key known): each
              body's rows/s, each must take the native columnar branch
              (the tenant's columnar space gains every series' key with
              the first body, none with the second, nothing dropped),
              and the server's
              search_columns of each equals a store written by add_rows
              with the same rows (by name and order, timestamps exactly,
              values bit for bit); (c) the full width's 100,000 counters
              (32 series an instance) for the first STORE_HOURS of the
              24 hours, a cut from the 6 planned printed as a "cut"
              line, every series
              kept, through Storage.add_rows_columnar,
              40 scrapes a call: rows/s, the close, bytes on disk and the
              peak host RSS; the store reopened, its search_columns equal
              to the in-memory cut (timestamps exactly, values bit for
              bit)
  mesh        the multi-device paths on 8 logical shards of this card
              (every shard on cuda:0): (a) the dashboard through
              CUDAEngine(mesh=make_mesh(8, 1)): the cold query (K1 per
              shard, B13 sharded_rollup_aggregate) and the first
              MESH_DASH_REFRESHES of the dashboard's six refreshes (a
              "cut" line; K3 per shard, K4 at the resume), the replayed
              scrapes written through add_rows_columnar, every aggregate
              held
              against the unsharded engine (count, group, min and max bit
              for bit, sum and avg at rtol 1e-12, stddev and stdvar at the
              tests' allowances) and each served result against its own
              cold rebuild; (b) the full-width cold query over the
              hours the ingest phase wrote to its store, every series
              kept, the columns read back from the store grouped by
              instance, through the sharded engine, held
              the same way against K2 on the same cut tile unsharded (the
              shards' row blocks side by side); (c) B15
              time_sharded_rollup on a (2, 4) mesh over the full-width
              tile's columns, against B5 at 1e-9, each call one launch
              per phase; (d) B14:
              16 standing queries in 2 buckets of 8 on an 8-way stream
              mesh through one steady interval and a 30-minute resume
              (a cut from two steady intervals), against the same streams
              on an unsharded fleet, bit for bit; (e) B12 decode_and_rollup on the dashboard's and
              the full width's delta planes, against K1 -> B5 bit for bit
              and against its plain version, timed beside K1 -> B5.  (a)
              and (d) read a second Storage opened on a copy of the
              dashboard's store directory, taken before its refreshes,
              fed the same refresh scrapes
  cluster     the port's cluster on the card's host: three vmstorage
              processes (``python -m victoriametrics_tpu_torch.apps.
              vmstorage``, each its own data directory and ports on
              127.0.0.1), vminsert at -replicationFactor=2 and vmselect at
              the same factor in this process, started with no backend
              flag (its build waits for the card's attach, on a thread
              while the hour goes in); the first
              CLUSTER_HOURS of the full width's 100,000 counters (a "cut"
              line) through vminsert's ClusterStorage.add_rows_columnar
              from three concurrent writers, each owning a third of the
              instances, 40 scrapes a call (the registering round's
              seconds, later rounds' rows/s), one more scrape through
              vminsert's /api/v1/write; the nodes' flush through
              /internal/force_flush, each node's rows and bytes on disk,
              every series on exactly two nodes (seriesCount_v1 and
              searchMetricNames_v1 on each).  Through vmselect's
              /api/v1/query_range: the cold sum by (instance)(rate[5m])
              over the hour at step 15 s (K1 + K2; equal at rtol 1e-12 to
              the same query on the ingest phase's store on the card and
              to vmselect's host evaluator), count by instance bit for bit
              against the store (K2 on the tile the sum decoded when the
              fetched columns match it; min and max are a "cut" line); the
              refresh
              one step on (the reference's route over a cluster: the
              rollup result cache computes the new step from a fetch of
              its window, K1 + K2, no K3; rtol 1e-12 against the host);
              Graphite's /render through vmselect (one instance's series
              summed over the hour) equal as bytes to the same request
              to the single store; one node SIGKILLed (the same answer,
              isPartial false); two down (isPartial true, and 503 from a
              vmselect with -search.denyPartialResponse, served on the
              host: it answers no query); the last node's SIGTERM (exit
              0, "shutdown complete").  Each query's round trip, engine
              split and the server's cost split are recorded
  uploads     (inside kernels and full_width) both host->device paths of
              the tile cache, pinned-staged and direct, timed on a
              refresh's new columns and on cold delta planes

Then one JSON line summarising every kernel, the card's name and power
limit as nvidia-smi reports them, and the last line
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a
CUDA device, or when any build, launch or check fails, the script exits
non-zero before the last line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from victoriametrics_tpu_torch import kernels, native
from victoriametrics_tpu_torch.models import tile_cache
from victoriametrics_tpu_torch.ops import device_decode as dd
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops import decimal as dec
from victoriametrics_tpu_torch.ops import encoding as enc
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.parallel import mesh as meshlib
from victoriametrics_tpu_torch.parallel.partition import split_rows
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query import fleet
from victoriametrics_tpu_torch.query import rollup_result_cache as rrc
from victoriametrics_tpu_torch.query.exec import exec_query, parse_cached
from victoriametrics_tpu_torch.query.types import EvalConfig
from victoriametrics_tpu_torch.storage.metric_name import MetricName
from victoriametrics_tpu_torch.storage.storage import SeriesData, Storage
from victoriametrics_tpu_torch.storage.tag_filters import TagFilter
from victoriametrics_tpu_torch.timing import (
    MEM_BYTES_PER_S, SCALAR_OPS_PER_S, bound, cuda_ms, device_ms,
    fleet_bound, library_or_oom, quantile_bound, take_rows_bound, three_ms,
    topk_bound)
from victoriametrics_tpu_torch.utils import metrics as metricslib
from victoriametrics_tpu_torch.utils import querytracer

DAY = 86_400_000
# unix ms of the first scrape: this time of day (bench.py's anchor's), on
# the day two to three days before the run, so that every sample the
# dashboard, fleet and mesh phases write (about 9 h of them) lies in the
# past and inside the store's default retention (13 months)
T_REF = 1_753_700_000_000
T_START = T_REF + (int(time.time() * 1000) - 2 * DAY - T_REF) // DAY * DAY
SCRAPE = 15_000
JITTER = 2_000
WINDOW = 300_000
LOOKBACK_DELTA = 300_000
#: the serving front end's series limit (the reference's PrometheusAPI
#: default), which the fleet's analysis reads from its evaluation context
MAX_SERIES = 1_000_000

# dashboard: bench.py's headline shape
DASH_SERIES, DASH_SAMPLES, DASH_GROUPS, DASH_STEP = 8192, 1440, 256, 60_000
# (scrapes ingested before the refresh, ms the window advances)
DASH_REFRESHES = [(1, SCRAPE)] * 3 + [(420, 420 * SCRAPE)] + [(1, SCRAPE)] * 2
# full width: BASELINE.md config 2
FULL_SERIES, FULL_PER_GROUP, FULL_STEP = 100_000, 32, 15_000
# the dashboard's selector, the storage filters it parses to (a metric
# name, as query/eval.py's search_series call passes them) and the tenant
SELECTOR = "http_requests_total"
FILTERS = [TagFilter(b"", SELECTOR.encode())]
TENANT = (0, 0)
# scrapes per write call when the dashboard's history goes into the
# store: 40 whole scrapes of 8192 series, 327,680 rows a call
SCRAPES_PER_CALL = 40
# fleet: the standing queries' funcs, and their grids as (duration, step,
# groupings): A the dashboard panel's range on its 60 s step (5 h 54 m:
# its tile, slid at the resume refresh, holds no longer history), B the
# last hour at the scrape interval.  The roll-state key that names a fleet
# member carries no grid or window (the reference's), so one expression on
# two grids would share one member: B's panels group with `without`, the
# same groups written as expressions of their own
FLEET_FUNCS = ("rate", "increase", "irate", "max_over_time")
#: the fleet phase's standing queries' funcs: 64 queries in 8 buckets, a
#: depth cut (a "cut" line) from FLEET_FUNCS' 128 in 16 made when the
#: satellites phase came (adoption is about 1 s a stream)
FLEET_STANDING_FUNCS = ("rate", "max_over_time")
FLEET_GRIDS = {
    "A": (354 * 60_000, 60_000, ((("instance",), False), ((), False))),
    "B": (3_600_000, SCRAPE, ((("id",), True), (("instance", "id"), True)))}
# (scrapes per series ingested before the interval, ms the clock advances):
# five steady minutes, then a resume after 30 minutes that overruns grid
# B's column headroom (B11) and not grid A's
FLEET_INTERVALS = [(4, 60_000)] * 5 + [(120, 1_800_000)]
# the phase's bucket shape in the kernels phase: slots, live streams,
# columns, steps
FLEET_B, FLEET_LIVE, FLEET_N, FLEET_T = 12, 9, 2048, 384

SOURCES = {
    "decode_tiles": ("victoriametrics_tpu_torch/csrc/decode.cu",
                     "victoriametrics_tpu/ops/device_decode.py:136"),
    "rollup_aggregate_tile": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                              "victoriametrics_tpu/ops/device_rollup.py:750"),
    "append_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                    "victoriametrics_tpu/ops/device_rollup.py:784"),
    "compact_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                     "victoriametrics_tpu/ops/device_rollup.py:830"),
    "rollup_tile": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                    "victoriametrics_tpu/ops/device_rollup.py:300"),
    "topk_select_tile": ("victoriametrics_tpu_torch/csrc/select.cu",
                         "victoriametrics_tpu/ops/device_rollup.py:887"),
    "take_rows": ("victoriametrics_tpu_torch/csrc/select.cu",
                  "victoriametrics_tpu/ops/device_rollup.py:939"),
    "rank_tile": ("victoriametrics_tpu_torch/csrc/select.cu",
                  "victoriametrics_tpu/ops/device_rollup.py:904"),
    "rollup_quantile_tile": ("victoriametrics_tpu_torch/csrc/quantile.cu",
                             "victoriametrics_tpu/ops/device_rollup.py:948"),
    "fleet_rollup_aggregate_tile": (
        "victoriametrics_tpu_torch/csrc/rollup.cu",
        "victoriametrics_tpu/ops/device_rollup.py:737"),
    "fleet_append_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                          "victoriametrics_tpu/ops/device_rollup.py:800"),
    "fleet_compact_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                           "victoriametrics_tpu/ops/device_rollup.py:851"),
    "decode_and_rollup": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                          "victoriametrics_tpu/ops/device_decode.py:157"),
    "sharded_rollup_aggregate": ("victoriametrics_tpu_torch/csrc/mesh.cu",
                                 "victoriametrics_tpu/parallel/mesh.py:103"),
    "cached_fleet_rollup_aggregate": (
        "victoriametrics_tpu_torch/csrc/rollup.cu",
        "victoriametrics_tpu/parallel/mesh.py:68"),
    "time_sharded_rollup": ("victoriametrics_tpu_torch/csrc/mesh.cu",
                            "victoriametrics_tpu/parallel/mesh.py:141"),
}
#: the fleet phase's kernels, whose launches count on its own path
FLEET_KERNELS = ("fleet_rollup_aggregate_tile", "fleet_append_tile",
                 "fleet_compact_tile")
#: the mesh phase's kernels, whose launches count on its own path
MESH_KERNELS = ("decode_and_rollup", "sharded_rollup_aggregate",
                "cached_fleet_rollup_aggregate", "time_sharded_rollup")
# the mesh phase: logical shards of the card, B15's (series, time) mesh,
# step and halo (>= window / scrape + 2 samples), and the fleet part's
# intervals: two steady minutes, then the 30-minute resume that slides
# grid B's windows (B11 per shard)
MESH_SHARDS = 8
#: hours of the full width's history the ingest phase writes to its store
#: and the mesh phase's sharded cold query (part b) reads back: a depth cut
#: (every series kept) from the 6 h planned, printed as a "cut" line.
#: Written through add_rows_columnar, closed and read back, each hour of
#: 100,000 series costs 20-40 s of host time: at 6 h the script ran past
#: its 1200 s on the card's host, and at 3 h it took 943-1128 s; cut to
#: 1 h when the cluster phase came (its own ~4 minutes)
STORE_HOURS = 1
#: the cluster phase: three vmstorage processes with every series on two of
#: them (the reference's cluster documentation's layout for surviving one
#: node's loss), the first hour of the full width written through vminsert
#: by three concurrent writers, each owning the instances i % 3 == k (a
#: scraper's share of the targets).  Its vminsert and vmselect take a
#: 120 s RPC timeout (a backfill call that registers a third of the
#: series outlasts the 10 s default, and a timed-out write would reroute)
#: and vmselect a 300 s query budget (a cold query fetches 24 M samples
#: from the nodes)
CLUSTER_NODES, CLUSTER_RF, CLUSTER_AGENTS = 3, 2, 3
CLUSTER_HOURS = 1
CLUSTER_START_S = 180
CLUSTER_FLAGS = ("-rpc.timeout=120",)
CLUSTER_SELECT_FLAGS = ("-search.maxQueryDuration=300s",)
CLUSTER_FEED_SEED = 17
#: the ingest phase: scrapes of the dashboard's 8192 series each insert
#: route's measured body carries (after one body that registers them),
#: and the full width's metric name on its store
INGEST_SCRAPES = 4
FULL_SELECTOR = "fw_requests_total"
B15_MESH, B15_STEP, B15_HALO = (2, 4), 60_000, 32
#: depth cuts of the mesh phase's dashboard and fleet parts (each printed
#: as a "cut" line), made when the cluster phase came: the first
#: MESH_DASH_REFRESHES of the dashboard's six refreshes (the one-scrape
#: refreshes' K3 and the resume's K4 kept), and one steady fleet interval
#: of the planned two before the resume (B10 and B11 kept)
MESH_DASH_REFRESHES = 4
MESH_FLEET_INTERVALS = [(4, 60_000)] + [(120, 1_800_000)]
MESH_FLEET_PLANNED = 3
#: hours of the full width's history (the full_width phase, the host
#: codec's full-width part, the mesh's B15 and B12 on its planes), a
#: depth cut from BASELINE config 2's 24 h (a "cut" line) made when the
#: cluster phase came; series, groups, step and window are never cut
FULL_HOURS = 6.0
# the quantile probabilities every B8 check runs
PHIS = (-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5)
# funcs whose kernel and plain version do the same operations with no sum
# and no division: held bit for bit (NaN positions included).  The
# time-valued funcs and lag divide by 1e3, which torch does for a CUDA
# tensor through the reciprocal, an ulp away from the kernel's division.
EXACT_FUNCS = frozenset({
    "count_over_time", "present_over_time", "first_over_time",
    "last_over_time", "default_rollup", "min_over_time", "max_over_time",
    "changes"})


def dashboard_grid() -> tuple[int, int]:
    """(start, end) of the dashboard's first query, as bench.py sets it:
    the end lies beyond every initial sample (jitter included), the range
    spans the history less five minutes."""
    end = T_START + -(-((DASH_SAMPLES - 1) * SCRAPE + JITTER) // DASH_STEP) \
        * DASH_STEP
    return end - ((DASH_SAMPLES - 1) * SCRAPE - 300_000), end


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| where both are numbers; inf when the NaN
    patterns differ or one side is infinite where the other is not."""
    got, want = got.double(), want.double()
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        return float("inf")
    same = torch.isnan(got) | (got == want)
    if not bool(torch.isfinite(torch.where(same, 0.0, got - want)).all()):
        return float("inf")
    d = torch.where(same, 0.0, (got - want).abs())
    return float(d.max()) if d.numel() else 0.0


def assert_close(what: str, got, want, rtol: float, atol: float) -> float:
    g = got.double().cpu().numpy() if torch.is_tensor(got) else got
    w = want.double().cpu().numpy() if torch.is_tensor(want) else want
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True,
                               err_msg=what)
    return max_abs_err(torch.as_tensor(g), torch.as_tensor(w))


def assert_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    a, b = got, want
    if got.dtype == torch.float64:  # bit patterns, NaN payloads included
        a, b = got.view(torch.int64), want.view(torch.int64)
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: not bit-identical")
    return 0.0


def assert_exact(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Same NaN positions and the same bits everywhere else."""
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    live = ~torch.isnan(got)
    if not torch.equal(got[live].view(torch.int64),
                       want[live].view(torch.int64)):
        raise AssertionError(f"{what}: not bit-identical")
    return 0.0


def assert_same_values(what: str, got: torch.Tensor,
                       want: torch.Tensor) -> float:
    """The same numbers at the same places: NaN positions equal and every
    other value equal as a number (-0.0 == 0.0: the plain aggregates'
    scatter does not order signed zeros)."""
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    live = ~torch.isnan(got)
    if not torch.equal(got[live], want[live]):
        raise AssertionError(f"{what}: values differ")
    return 0.0


def _loose(func: str) -> tuple[float, float]:
    """(rtol, atol) of a func whose moment formula cancels: deriv and
    stdvar_over_time 1e-9; stddev_over_time the reference oracle's own
    bound, rtol 1e-6, atol 1e-4 (tests/test_device_rollup.py:69-74): a
    zero-variance window's stddev is the square root of a summation-order
    residual."""
    return (1e-6, 1e-4) if func == "stddev_over_time" else (1e-9, 1e-9)


def func_close(what, func, got, want) -> float:
    """Kernel vs plain per-series rollup: bit for bit for EXACT_FUNCS,
    rtol 1e-12 where only the summation order can differ, _loose for the
    cancelling moment formulas (see tests/test_torch_rollup_tile.py)."""
    if func in EXACT_FUNCS:
        return assert_exact(what, got, want)
    if func in ("deriv", "stddev_over_time", "stdvar_over_time"):
        return assert_close(what, got, want, *_loose(func))
    return assert_close(what, got, want, 1e-12, 0.0)


def aggr_close(what, aggr, got, want, func="rate", mean=None) -> float:
    """The tolerance of the port's tests: rtol 1e-12 for the sums and
    extrema; the variance to rtol 1e-9, atol 1e-9, stddev through its
    square, plus, for the funcs other than the counter funcs, 16 ulp of
    the squared group mean (its cancellation); the cancelling funcs at
    _loose (see tests/test_torch_device_rollup.py)."""
    loose = func in ("deriv", "stddev_over_time", "stdvar_over_time")
    rtol, atol = _loose(func) if loose else (1e-9, 1e-9)
    if aggr in ("stddev", "stdvar"):
        g, w = (got * got, want * want) if aggr == "stddev" else (got, want)
        g, w = g.double().cpu(), w.double().cpu()
        scale = atol
        if mean is not None and func not in dr.COUNTER_FUNCS:
            scale = atol + 16 * torch.finfo(torch.float64).eps * (
                1 + torch.nan_to_num(mean.double().cpu()) ** 2)
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{what}: NaN positions differ")
        bad = ((g - w).abs() > scale + rtol * w.abs()) & ~torch.isnan(w)
        if bool(bad.any()):
            raise AssertionError(f"{what}: {g[bad][:5]} vs {w[bad][:5]}")
        return max_abs_err(got, want)
    if loose:
        return assert_close(what, got, want, rtol, atol)
    return assert_close(what, got, want, 1e-12, 0.0)


# ---------------------------------------------------------------------------
# Workloads, made from the seed with numpy.
# ---------------------------------------------------------------------------

def counters(rng, S: int, N: int, t0: int):
    """S jittered 15 s counters of N samples from t0 (rows stay sorted:
    the jitter is under half the scrape interval)."""
    ts = t0 + np.arange(N, dtype=np.int64)[None, :] * SCRAPE + \
        rng.integers(-JITTER, JITTER + 1, (S, N))
    vals = np.cumsum(rng.integers(0, 50, (S, N)), axis=1).astype(np.float64)
    return ts, vals


def ragged_series(rng):
    """Edge-case rows: single sample, two samples, everything before the
    range, sparse gaps, counter resets, a reset to a negative value, a NaN
    sample, a counter starting at -0.0, plus ordinary counters and
    gauges."""
    out = []
    for i in range(40):
        n = int(rng.integers(3, 200))
        ts = np.sort(T_START + np.arange(n, dtype=np.int64) * SCRAPE +
                     rng.integers(-JITTER, JITTER, n))
        v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        if i % 4 == 1:
            v = np.round(rng.uniform(0, 100, n), 3)
        elif i % 4 == 2:
            for p in rng.integers(1, n, 3):
                v[p:] -= v[p]
            v = np.abs(v)
        elif i % 4 == 3 and n > 10:
            v[n // 2:] -= v[n // 2] + 40.0
        out.append((ts, v))
    out.append((np.array([T_START + 700_000]), np.array([42.0])))
    out.append((np.array([T_START + 700_000, T_START + 710_000]),
                np.array([1.0, 5.0])))
    out.append((np.array([T_START - 50_000]), np.array([7.0])))
    out.append((np.array([T_START, T_START + 900_000, T_START + 1_700_000]),
                np.array([1.0, 100.0, 3.0])))
    ts = T_START + np.arange(150, dtype=np.int64) * SCRAPE
    v = np.cumsum(rng.integers(0, 50, 150)).astype(np.float64)
    v[90] = np.nan
    out.append((ts, v))
    v = np.cumsum(rng.integers(0, 50, 150)).astype(np.float64)
    v[:3] = -0.0
    out.append((ts, v))
    return out


def planes_for(series_tv, start_ms: int, n_cap: int | None = None):
    """(ts, values) series -> delta planes padded to the tile capacity, as
    the engine's cold upload builds them."""
    triples = []
    for ts, v in series_tv:
        m, e = dec.float_to_decimal(v)
        triples.append((ts, m, e))
    planes = dd.pack_delta_planes(triples, start_ms)
    if planes is None:
        raise AssertionError("workload does not fit int32 delta planes")
    n_cap = n_cap or ce.tile_capacity(int(planes.counts.max()))
    pad = max(n_cap - 2 - planes.ts_d2.shape[1], 0)
    planes.ts_d2 = np.pad(planes.ts_d2, ((0, 0), (0, pad)))
    planes.val_d2 = np.pad(planes.val_d2, ((0, 0), (0, pad)))
    return planes, n_cap


def plane_tensors(planes, device):
    return [tile_cache.chunked_device_put(getattr(planes, f), device)
            for f in ("ts_first", "ts_fdelta", "ts_d2", "val_first",
                      "val_fdelta", "val_d2", "scale", "counts")]


class Stores:
    """The port's stores of this run, each in its own directory under one
    temporary directory: every store still open is closed, and the
    directory removed, by close_all (also when a phase fails)."""

    def __init__(self):
        self.root = tempfile.mkdtemp(prefix="chip_smoke_store_")
        self.open_stores = []

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def open(self, name: str) -> Storage:
        st = Storage(self.path(name))
        self.open_stores.append(st)
        return st

    def close(self, st: Storage) -> None:
        self.open_stores.remove(st)
        st.close()

    def close_all(self) -> None:
        try:
            while self.open_stores:
                self.close(self.open_stores[-1])
        finally:
            shutil.rmtree(self.root, ignore_errors=True)


def dash_labels(S: int) -> list[dict]:
    """The dashboard's series: `SELECTOR{instance="host-<i % 256>",
    id="<i>"}` (ids not zero-padded: the store's name order is not this
    order)."""
    return [{"__name__": SELECTOR, "instance": f"host-{i % DASH_GROUPS}",
             "id": str(i)} for i in range(S)]


def ingest(store: Storage, labels, ts, vals,
           per_call: int = SCRAPES_PER_CALL) -> float:
    """(S, k) columns into the store through add_rows, `per_call` whole
    scrapes a call, scrape after scrape as a scraper sends them; returns
    the wall seconds of the add_rows calls."""
    took = 0.0
    for j0 in range(0, ts.shape[1], per_call):
        rows = [(labels[i], t, v) for tr, vr in zip(
            ts[:, j0:j0 + per_call].T.tolist(),
            vals[:, j0:j0 + per_call].T.tolist())
            for i, (t, v) in enumerate(zip(tr, vr))]
        t0 = time.perf_counter()
        if store.add_rows(rows) != len(rows):
            raise AssertionError("the store dropped rows")
        took += time.perf_counter() - t0
    return took


def series_keys(labels) -> tuple[bytes, np.ndarray, np.ndarray]:
    """The canonical raw series keys (``name{k="v",...}``, the native
    parsers' form) of label dicts, as one buffer with each key's offset
    and length."""
    from victoriametrics_tpu_torch.ingest.parsers import \
        series_key_from_labels
    keys = [series_key_from_labels(sorted(lb.items())) for lb in labels]
    lens = np.array([len(k) for k in keys], np.int64)
    offs = np.zeros(len(keys), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return b"".join(keys), offs, lens


def ingest_columnar(store: Storage, keys, ts, vals,
                    per_call: int = SCRAPES_PER_CALL, calls=None) -> float:
    """(S, k) columns into the store through add_rows_columnar, `per_call`
    whole scrapes a call, scrape after scrape as a scraper sends them: each
    call one native.ColumnarRows batch whose rows name their series by
    its raw key (`keys`: series_keys' buffer, offsets, lengths).  Returns
    the wall seconds of the add_rows_columnar calls (each call's appended
    to `calls` when given)."""
    keybuf, offs, lens = keys
    took = 0.0
    for j0 in range(0, ts.shape[1], per_call):
        k = min(per_call, ts.shape[1] - j0)
        cr = native.ColumnarRows(
            keybuf, np.tile(offs, k), np.tile(lens, k),
            np.ascontiguousarray(ts[:, j0:j0 + k].T).ravel(),
            np.ascontiguousarray(vals[:, j0:j0 + k].T).ravel())
        t0 = time.perf_counter()
        if store.add_rows_columnar(cr, tenant=TENANT) != len(cr):
            raise AssertionError("the store dropped rows")
        dt = time.perf_counter() - t0
        took += dt
        if calls is not None:
            calls.append(dt)
    return took


def columnar_keys(store: Storage) -> int:
    """The raw series keys the tenant's columnar space holds: only
    add_rows_columnar fills it."""
    sp = store._cspaces.get(TENANT)
    return 0 if sp is None or sp.keymap is None else len(sp.keymap)


class Feed:
    """The counters' continuation: k more scrapes per series, each 15 s
    apart, all in (after_ms, after_ms + k * 15 s], strictly newer than
    anything a query up to after_ms has seen."""

    def __init__(self, seed: int, last: np.ndarray):
        self.rng = np.random.default_rng(seed)
        self.last = last.copy()
        #: every (ts, vals) made, when a list (the satellites phase's
        #: Graphite check rebuilds the store's last hour from it)
        self.history = None

    def next(self, k: int, after_ms: int):
        ts, incr = counters(self.rng, self.last.size, k,
                            after_ms + SCRAPE // 2)
        vals = self.last[:, None] + incr
        self.last = vals[:, -1].copy()
        if self.history is not None:
            self.history.append((ts, vals))
        return ts, vals


def fetch_phases() -> dict[str, float]:
    """Seconds the port's stores spent answering searches so far, by
    their own fetch phase counters (index_search, collect or
    assemble_native, decode, assemble, queue_wait)."""
    head = 'vm_fetch_phase_seconds_total{phase="'
    return {k[len(head):-2]: v
            for k, v in metricslib.REGISTRY.snapshot().items()
            if k.startswith(head)}


def fetch_s() -> float:
    """The sum of fetch_phases()."""
    return sum(fetch_phases().values())


def phases_ms(before: dict, after: dict) -> dict[str, float]:
    return {k: (v - before.get(k, 0.0)) * 1e3 for k, v in after.items()
            if v != before.get(k, 0.0)}


def instance_groups(series) -> tuple[np.ndarray, list]:
    """Group ids by the `instance` label in the store's row order, the
    first group seen first (query/eval.py's grouping), and each group's
    key."""
    index, keys = {}, []
    gids = np.empty(len(series), np.int32)
    for i, sd in enumerate(series):
        inst = sd.metric_name.get_label(b"instance").decode()
        g = index.get(inst)
        if g is None:
            g = index[inst] = len(keys)
            keys.append((("instance", inst),))
        gids[i] = g
    return gids, keys


def disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def upload_paths(what: str, arrays, dev, reps: int = 5) -> dict:
    """Host wall ms to put `arrays` on the card through each of the tile
    cache's two paths, pinned-staged and direct: medians of `reps`
    alternating rounds after one checked warm-up round each."""
    paths = {"staged": tile_cache.staged_put, "direct": tile_cache.direct_put}

    def put_all(put):
        t0 = time.perf_counter()
        out = [put(a, dev) for a in arrays]
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, out

    for name, put in paths.items():
        for a, t in zip(arrays, put_all(put)[1]):
            if not torch.equal(t.cpu(), torch.from_numpy(a)):
                raise AssertionError(f"{what}: {name} upload differs")
    times = {name: [] for name in paths}
    for _ in range(reps):
        for name, put in paths.items():
            times[name].append(put_all(put)[0])
    return {"what": what, "arrays": len(arrays),
            "bytes": int(sum(a.nbytes for a in arrays)),
            "largest_array_bytes": int(max(a.nbytes for a in arrays)),
            **{f"{name}_ms": float(np.median(t)) * 1e3
               for name, t in times.items()}}


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def check_ranks(what: str, rolled) -> None:
    """B7 against its plain version: median and last bit for bit, avg at
    rtol 1e-12 (the plain cumsum's order differs), max and min equal as
    numbers (which zero torch.amax returns among -0.0 and 0.0 is not
    specified)."""
    for kind in dr.RANK_KINDS:
        g, w = dr.rank_rows(rolled, kind), dr.rank_rows_plain(rolled, kind)
        if kind in ("median", "last"):
            assert_exact(f"B7 {what} {kind}", g, w)
        else:
            assert_close(f"B7 {what} {kind}", g, w,
                         1e-12 if kind == "avg" else 0.0, 0.0)


def rank_edge_rows(T: int, rng, dev) -> torch.Tensor:
    """Rows of T steps holding B7's edge cases at shuffled steps (NaN
    elsewhere): no live step, one, two; ties straddling the median; -0.0
    and +0.0 at j0 and j1; infinities; constant rows; a run of ties with
    one outlier; and random rows (tests/test_torch_rank_rows.py holds the
    plain version against the reference on the same cases)."""
    h = T // 2
    cases = [
        [], [1.5], [2.0, -3.0],
        [1.0] * h + [2.0] * (T - h), [1.0] * (h + 1) + [2.0] * (T - h - 1),
        [-0.0, 0.0], [0.0, -0.0, 0.0], [-0.0] * h + [0.0] * (T - h),
        [np.inf, -np.inf] * h, [np.inf] * T, [-np.inf] * 3 + [np.inf] * 2,
        [7.25] * T, [7.25] * (T - 1), [-0.0] * T,
        [0.0] * (T - 1) + [1e300], [-1e300] + [5.0] * (T - 1),
        list(rng.normal(0, 1, T)), list(rng.integers(0, 3, T) * 1.0)]
    out = np.full((len(cases), T), np.nan)
    for r, vals in enumerate(cases):
        vals = np.asarray(vals[:T], dtype=np.float64)
        out[r, rng.permutation(T)[:vals.size]] = vals
    return torch.from_numpy(out).to(dev)


def topk_ks(S: int) -> list[int]:
    """B6's k at every path boundary: the old register path's 16 | 17,
    the scan path's K_REG | K_REG + 1 (the sort path), and S."""
    return sorted({k for k in (1, 10, 16, 17, dr.K_REG, dr.K_REG + 1, S)
                   if k <= S})


def check_topk(what: str, rolled, ks=None) -> None:
    """B6 against its plain version, picks and NaN flags bit for bit, at
    each k of ks (every k of topk_ks by default), top and bottom."""
    for bottom in (False, True):
        for k in ks or topk_ks(rolled.shape[0]):
            gi, gn = dr.topk_select(rolled, k, bottom)
            wi, wn = dr.topk_select_plain(rolled, k, bottom)
            assert_equal(f"B6 {what} k={k} bottom={bottom} idx", gi, wi)
            assert_equal(f"B6 {what} k={k} bottom={bottom} nan", gn, wn)


def check_selections(what: str, rolled, dev) -> None:
    """B6, take_rows, B7 and B8 on one rolled tile against their plain
    versions: B6 at every k of topk_ks top and bottom, take_rows with
    int32 and int64 indices (out-of-range ones among them), every rank
    kind, every phi at groups of 32 and at one group of all rows."""
    S, T = rolled.shape
    check_topk(what, rolled)
    sel = torch.tensor([S - 1, -1, 0, S, S // 2, -S - 3, 2 * S], device=dev)
    for dtype in (torch.int64, torch.int32):
        assert_equal(f"take_rows {what} {dtype}",
                     dr.take_rows(rolled, sel.to(dtype)),
                     dr.take_rows_plain(rolled, sel.to(dtype)))
    check_ranks(what, rolled)
    for n_groups in (max(S // 32, 1), 1):
        gids = (torch.arange(S, device=dev) % n_groups).to(torch.int32)
        groups = dr.group_layout(gids, n_groups, dev)
        for phi in PHIS:
            assert_exact(f"B8 {what} M={groups.max_group} phi={phi}",
                         dr.quantile_groups(rolled, groups, phi),
                         dr.quantile_groups_plain(rolled, groups, phi))


def check_quantile(what: str, rolled, groups, want_plan) -> dict:
    """B8 bit for bit against its plain version at every phi, on the path
    `want_plan` names ((path, cluster, staged), None for any)."""
    S, T = rolled.shape
    plan = dr.quantile_plan(groups.num_groups, T, groups.max_group,
                            kernels.sm_count(rolled.device))
    if want_plan is not None and \
            (plan.path, plan.cluster, plan.staged) != want_plan:
        raise AssertionError(f"B8 {what}: plan {plan}, not {want_plan}")
    for phi in PHIS:
        assert_exact(f"B8 {what} phi={phi}",
                     dr.quantile_groups(rolled, groups, phi),
                     dr.quantile_groups_plain(rolled, groups, phi))
    return plan._asdict()


def check_quantile_paths(rng, dev) -> dict:
    """B8's cluster and block paths at their edges, on values with ties,
    signed zeros, infinities and NaN: one group of 100,000 rows at one
    step (16 staged members), groups at and just above what a cluster
    stages (16 x 24,576 keys), a group that 16 does not divide, a group
    just above what one block stages (the block path, 132 steps), and
    three groups of which one is all NaN and one has a single live row."""
    pool = torch.tensor([-0.0, 0.0, 1.0, -1.0, torch.inf, -torch.inf,
                         torch.nan, 2.5], dtype=torch.float64, device=dev)

    def values(S, T):
        v = torch.from_numpy(np.round(rng.normal(0, 3, (S, T)), 1)).to(dev)
        pick = torch.from_numpy(rng.random((S, T)) < 0.3).to(dev)
        return torch.where(pick, pool[torch.from_numpy(
            rng.integers(0, 8, (S, T))).to(dev)], v)

    def one(S):
        return dr.group_layout(torch.zeros(S, dtype=torch.int32, device=dev),
                               1, dev)

    cl = dr.Q_CLUSTER
    plans = {}
    for what, S, T, want in (("one group 100000", 100_000, 1, (cl, 16, 1)),
                             ("cluster stage limit", 393_216, 1, (cl, 16, 1)),
                             ("above cluster stage", 393_217, 1, (cl, 16, 0)),
                             ("16 does not divide", 100_003, 2, (cl, 16, 1)),
                             ("above block stage", 24_577, 132,
                              (dr.Q_BLOCK, 1, 0))):
        plans[what] = check_quantile(what, values(S, T), one(S), want)
    r = values(60_000, 2)
    r[:40_000] = torch.nan         # group 0: all NaN
    r[40_000:50_000] = torch.nan   # group 1: one live row
    r[40_017] = 3.5
    gids = torch.repeat_interleave(
        torch.arange(3, device=dev, dtype=torch.int32),
        torch.tensor([40_000, 10_000, 10_000], device=dev))
    plans["nan and one live"] = check_quantile(
        "all NaN, one live", r, dr.group_layout(gids, 3, dev), (cl, 16, 1))
    return plans


def kernels_slice2(rng, dev, ts_t, v_t, counts, ragged) -> dict:
    """B5-B8 against their plain versions on the card (ragged rows, the
    dashboard tile, tie-heavy and wide tiles), timed at the dashboard
    shape."""
    res = {}
    S = DASH_SERIES
    start, end = dashboard_grid()
    cfg = dr.normalized_cfg("rate", RollupConfig(start, end, DASH_STEP,
                                                 WINDOW))
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    none = int(dr.MIN_TS_NONE)
    roll = (SCRAPE, -(WINDOW + LOOKBACK_DELTA))  # a refresh's (shift, min_ts)
    # B5: every func, on the ragged rows and the dashboard tile, with and
    # without a shift and a fetch bound
    rcfg0 = RollupConfig(T_START + 600_000, T_START + 1_800_000, 60_000,
                         WINDOW)
    err5 = 0.0
    cases = []
    for off, mt in ((0, none), (120_000, -420_000)):
        tsr, vr, cr = (torch.from_numpy(a).to(dev) for a in dr.pack_series(
            ragged, rcfg0.start - off))
        cases.append(("ragged", tsr, vr, cr, rcfg0, off, mt))
    dcfg0 = RollupConfig(start, end, DASH_STEP, WINDOW)
    cases += [("dashboard", ts_t, v_t, counts, dcfg0, 0, none),
              ("dashboard", ts_t, v_t, counts, dcfg0, *roll)]
    for what, tsx, vx, cx, cfg0, off, mt in cases:
        for func in dr.FUNC_CODES:
            if off and func in dr.TIME_VALUED_FUNCS:
                continue  # they refuse a shifted grid
            c = dr.normalized_cfg(func, cfg0)
            g = dr.rollup_tile(func, tsx, vx, cx, c, mt, off)
            # the plan's path (staged on these shapes) against the global
            # search, bit for bit
            assert_equal(f"B5 {func} {what} shift {off} plan vs global", g,
                         dr.rollup_tile(func, tsx, vx, cx, c, mt, off,
                                        force_global=True))
            w = dr.rollup_tile_plain(func, tsx - off, vx, cx, c, mt)
            e = func_close(f"B5 {func} {what} shift {off}", func, g, w)
            if func not in dr.TIME_VALUED_FUNCS and \
                    func not in ("deriv", "stddev_over_time",
                                 "stdvar_over_time"):
                err5 = max(err5, e)
    b5 = lambda: dr.rollup_tile("rate", ts_t, v_t, counts, cfg)  # noqa: E731
    rolled = b5()
    if not bool(torch.isfinite(rolled[:, WINDOW // DASH_STEP + 1:]).all()):
        raise AssertionError("B5 dashboard: non-finite rates")
    plan5 = dr.b5_plan(S, int(ts_t.shape[1]), T, cfg.step, cfg.lookback,
                       dr.scrape_hint(int(ts_t.shape[1]), T, cfg.step,
                                      cfg.lookback), kernels.sm_count(dev))
    if plan5.path != dr.K2_STAGED:
        raise AssertionError(f"B5 dashboard: plan {plan5} is not staged")
    res["rollup_tile"] = dict(
        max_abs_err=err5, ms=cuda_ms(b5), device_ms=device_ms(b5),
        global_device_ms=device_ms(lambda: dr.rollup_tile(
            "rate", ts_t, v_t, counts, cfg, force_global=True)),
        plan=plan5._asdict(),
        plain_ms=cuda_ms(lambda: dr.rollup_tile_plain(
            "rate", ts_t, v_t, counts, cfg), reps=3),
        ms_by_func={f: cuda_ms(lambda f=f: dr.rollup_tile(
            f, ts_t, v_t, counts, dr.normalized_cfg(f, dcfg0)), reps=3)
            for f in ("sum_over_time", "stddev_over_time", "deriv",
                      "changes", "default_rollup")},
        **bound(n_valid * 12 + S * 4 + S * T * 8, 15 * S * T))

    # B6, take_rows, B7, B8 on the dashboard rates, the ragged rows'
    # rates, a tile of ties (signed zeros, infinities, NaN rows) and, for
    # B6 and B7, tiles taller or wider than the kernels' shared-memory
    # staging
    pool = torch.tensor([-0.0, 0.0, 1.0, -1.0, torch.inf, -torch.inf,
                         torch.nan], dtype=torch.float64, device=dev)
    ties = pool[torch.from_numpy(rng.integers(0, 7, (S, T))).to(dev)]
    ties[::97] = torch.nan
    wide = torch.from_numpy(rng.normal(0, 1, (64, 30_000))).to(dev)
    wide[wide > 2.0] = torch.nan
    wide[3] = torch.nan
    tsr, vr, cr = cases[0][1:4]
    rag_rolled = dr.rollup_tile("rate", tsr, vr, cr,
                                dr.normalized_cfg("rate", rcfg0))
    for what, r in (("dashboard", rolled), ("ragged", rag_rolled),
                    ("ties", ties)):
        check_selections(what, r, dev)
    # B6 on a tile taller than the sort path stages in shared memory
    tall = pool[torch.from_numpy(rng.integers(0, 7, (30_000, 4))).to(dev)]
    tall[1::3] = torch.from_numpy(rng.normal(0, 1, (10_000, 4))).to(dev)
    check_topk("tall", tall)
    # row counts that no cluster of the plan divides: the last member's
    # range is shorter than the others'
    for what, r, rows in (("dashboard", rolled, 8191), ("ties", ties, 5001)):
        plan = dr.topk_plan(rows, T, 10, kernels.sm_count(dev))
        if plan.cluster < 2 or rows % plan.cluster == 0:
            raise AssertionError(f"B6 {rows} rows: plan {plan} splits evenly")
        check_topk(f"{what} rows :{rows}", r[:rows], (10, dr.K_REG))
    check_ranks("wide", wide)
    # B7's edge rows on each median path and its boundaries: the warp path
    # (T <= 1024, below, at and above a warp's 32), a block per row (the
    # full width's 5761, the most a block stages) and global memory
    for T_e in (1, 2, 31, 32, 33, 355, 1024, 1025, 5761, 24576, 24577):
        check_ranks(f"edge rows T={T_e}", rank_edge_rows(T_e, rng, dev))
    quantile_plans = check_quantile_paths(rng, dev)

    # times: cuda_ms as in earlier runs, device_ms (back-to-back calls)
    # and host_ms (the wrapper's host time), for the kernels and their
    # library calls
    key = dr._topk_key(rolled, False).T.contiguous()
    k10 = three_ms(lambda: dr.topk_select(rolled, 10, False))
    lib10 = three_ms(lambda: torch.topk(key, 10, dim=1))
    res["topk_select_tile"] = dict(
        max_abs_err=0.0,  # picks identical, checked above
        **k10, plain_ms=cuda_ms(lambda: dr.topk_select_plain(
            rolled, 10, False), reps=3),
        library_ms=lib10["ms"], library=lib10,
        k20=three_ms(lambda: dr.topk_select(rolled, 20, False)),
        library_k20=three_ms(lambda: torch.topk(key, 20, dim=1)),
        k_all=three_ms(lambda: dr.topk_select(rolled, S, False), n=10,
                       reps=3),
        plan_k10=dr.topk_plan(S, T, 10, kernels.sm_count(dev))._asdict(),
        **topk_bound(S, T, 10))
    idx, _ = dr.topk_select(rolled, 10, False)
    sel = torch.unique(idx.long())
    M = int(sel.numel())
    t64 = three_ms(lambda: dr.take_rows(rolled, sel))
    lib = three_ms(lambda: torch.index_select(rolled, 0, sel))
    sel32 = sel.to(torch.int32)
    res["take_rows"] = dict(
        max_abs_err=0.0, rows=M, **t64,
        int32=three_ms(lambda: dr.take_rows(rolled, sel32)),
        plain_ms=cuda_ms(lambda: dr.take_rows_plain(rolled, sel)),
        library_ms=lib["ms"], library=lib,
        **take_rows_bound(M, T))
    res["rank_tile"] = dict(
        max_abs_err=float(max_abs_err(dr.rank_rows(rolled, "avg"),
                                      dr.rank_rows_plain(rolled, "avg"))),
        ms=cuda_ms(lambda: dr.rank_rows(rolled, "median")),
        plain_ms=cuda_ms(lambda: dr.rank_rows_plain(rolled, "median")),
        library_ms=cuda_ms(lambda: torch.nanquantile(rolled, 0.5, dim=1)),
        ms_by_kind={k: cuda_ms(lambda k=k: dr.rank_rows(rolled, k))
                    for k in dr.RANK_KINDS},
        device_ms_by_kind={k: device_ms(lambda k=k: dr.rank_rows(rolled, k))
                           for k in dr.RANK_KINDS},
        # avg's one PyTorch call (NaN on an all-NaN row, as B7)
        library_avg_ms=cuda_ms(lambda: torch.nanmean(rolled, dim=1)),
        library_avg_device_ms=device_ms(
            lambda: torch.nanmean(rolled, dim=1)),
        plan=dr.rank_plan(S, T, kernels.sm_count(dev))._asdict(),
        ms_wide_median=cuda_ms(lambda: dr.rank_rows(wide, "median"), reps=3),
        **bound(S * T * 8 + S * 8, S * T))
    gids = (torch.arange(S, device=dev) % DASH_GROUPS).to(torch.int32)
    g32 = dr.group_layout(gids, DASH_GROUPS, dev)
    g_all = dr.group_layout(torch.zeros(S, dtype=torch.int32, device=dev), 1,
                            dev)
    dense = dr.dense_by_group(rolled, g32)
    dense_all = dr.dense_by_group(rolled, g_all)
    sms = kernels.sm_count(dev)
    res["rollup_quantile_tile"] = dict(
        max_abs_err=0.0,  # identical, checked above
        ms=cuda_ms(lambda: dr.quantile_groups(rolled, g32, 0.9)),
        plain_ms=cuda_ms(lambda: dr.quantile_groups_plain(rolled, g32, 0.9)),
        library_ms=cuda_ms(lambda: torch.nanquantile(dense, 0.9, dim=1)),
        ms_one_group=cuda_ms(lambda: dr.quantile_groups(rolled, g_all, 0.5)),
        library_ms_one_group=cuda_ms(lambda: torch.nanquantile(
            dense_all, 0.5, dim=1), reps=3),
        # ms, device_ms and host_ms of B8 and torch.nanquantile (on the
        # reference's dense [G, M, T]) at M = 32 and M = 8192
        m32=three_ms(lambda: dr.quantile_groups(rolled, g32, 0.9)),
        library_m32=three_ms(lambda: torch.nanquantile(dense, 0.9, dim=1)),
        m8192=three_ms(lambda: dr.quantile_groups(rolled, g_all, 0.5)),
        library_m8192=three_ms(lambda: torch.nanquantile(
            dense_all, 0.5, dim=1), n=10, reps=3),
        bound_ms_m8192=quantile_bound(S, T, 1)["bound_ms"],
        plan_m32=dr.quantile_plan(DASH_GROUPS, T, 32, sms)._asdict(),
        plan_m8192=dr.quantile_plan(1, T, S, sms)._asdict(),
        paths=quantile_plans, **quantile_bound(S, T, DASH_GROUPS))
    return res


def kernels_fleet(rng, dev, ts_t, v_t, counts) -> dict:
    """B9, B10 and B11 against their plain versions at a fleet bucket's
    shape: FLEET_B slots of FLEET_N columns holding the dashboard tile,
    FLEET_LIVE of them live streams, each with its own grid shift, fetch
    bound and aggregate (all eight mixed), its last 64 rows padded; the
    rest padded slots.  Slot 1 has a counter reset on every 64th row,
    slot 2 -0.0 at the row starts, slot 3 NaN and stale NaN samples,
    slots 4 and 5 gaps before the grid; the last group is empty in every
    stream.  B9 runs the fleet phase's funcs
    at the aggregate tolerances, B10 and B11 bit for bit.  Returns the
    largest difference per kernel."""
    S, N0 = ts_t.shape
    B, LIVE, N, G = FLEET_B, FLEET_LIVE, FLEET_N, DASH_GROUPS
    ts = torch.full((B, S, N), int(dr.TS_PAD), dtype=torch.int32, device=dev)
    vals = torch.zeros((B, S, N), dtype=torch.float64, device=dev)
    cnt = torch.zeros((B, S), dtype=torch.int32, device=dev)
    ts[:LIVE, :, :N0] = ts_t
    vals[:LIVE, :, :N0] = v_t
    cnt[:LIVE] = counts
    ts[:LIVE, -64:], vals[:LIVE, -64:], cnt[:LIVE, -64:] = int(dr.TS_PAD), \
        0.0, 0
    rows = torch.arange(0, S - 64, 64, device=dev)
    mid = (counts[rows].long() // 2)[:, None]
    cols = torch.arange(N, device=dev)[None, :]
    v1 = vals[1, rows]
    vals[1, rows] = torch.where(cols >= mid, v1 - v1.gather(1, mid), v1)
    vals[2, ::97, :3] = -0.0
    vals[3, 5::101, 10] = torch.nan
    vals[3, 7::101, 20] = dec.STALE_NAN
    # gaps: every 50th row of slots 4 and 5 has its first 40 samples 10
    # minutes earlier, so the sample before a window can lie below the
    # fetch bound, which gates it in slot 5 (min_ts) and not in slot 4
    gap = torch.arange(0, S - 64, 50, device=dev)
    ts[4:6, gap, :40] -= 600_000
    gids = torch.from_numpy(rng.integers(0, G - 1, (B, S))).to(
        device=dev, dtype=torch.int32)
    layout = dr.fleet_layout(gids, G, dev)
    aggr = torch.tensor([b % 8 if b < LIVE else 0 for b in range(B)],
                        dtype=torch.int32, device=dev)
    shift = torch.tensor([b * SCRAPE for b in range(B)], dtype=torch.int32,
                         device=dev)
    min_ts = torch.tensor(
        [-(WINDOW + LOOKBACK_DELTA) if b % 2 else int(dr.MIN_TS_NONE)
         for b in range(B)], dtype=torch.int32, device=dev)
    v0 = torch.zeros((B, S), dtype=torch.float64, device=dev)
    cfg0 = RollupConfig(0, (FLEET_T - 1) * DASH_STEP, DASH_STEP, WINDOW)
    names = {code: name for name, code in dr.FLEET_AGGR_CODES.items()}
    err = dict.fromkeys(FLEET_KERNELS, 0.0)
    for func in FLEET_FUNCS:
        cfg = dr.normalized_cfg(func, cfg0)
        args = (func, cfg, layout, ts, vals, cnt, aggr, shift, min_ts, v0)
        got = dr.fleet_rollup_aggregate_tile(*args)
        want = dr.fleet_rollup_aggregate_tile_plain(*args)
        mean = None
        if func not in dr.COUNTER_FUNCS:  # the variance's 16-ulp term
            mean = dr.fleet_rollup_aggregate_tile_plain(
                func, cfg, layout, ts, vals, cnt, torch.full_like(aggr, 2),
                shift, min_ts, v0)
        for b in range(LIVE):
            name = names[int(aggr[b])]
            e = aggr_close(f"B9 {func} slot {b} {name}", name, got[b],
                           want[b], func, None if mean is None else mean[b])
            if name not in ("stddev", "stdvar"):
                err["fleet_rollup_aggregate_tile"] = max(
                    err["fleet_rollup_aggregate_tile"], e)
        if not (bool(torch.isnan(got[LIVE:]).all()) and
                bool(torch.isnan(got[:, G - 1]).all())):
            raise AssertionError(f"B9 {func}: a padded slot or the empty "
                                 "group is not NaN")
        if not bool(torch.isfinite(got[:LIVE, :G - 1]).any()):
            raise AssertionError(f"B9 {func}: no finite value")
    # B9 over groups larger than its chunk (FLEET_CHUNK), which it walks in
    # chunks and folds: in slots 0, 3, ... every row is one group; in 1,
    # 4, ... three interleaved groups of ~2731 rows (the last chunk
    # shorter); in 2, 5, ... a group of the first 300 rows, one of every
    # 40th row after them (~197: one pass) and one of the rest
    r = torch.arange(S, device=dev)
    gids1 = torch.zeros((B, S), dtype=torch.int32, device=dev)
    gids1[1::3] = (r % 3).to(torch.int32)
    gids1[2::3] = torch.where(r < 300, 0, torch.where(r % 40 == 0, 1, 2)).to(
        torch.int32)
    layout1 = dr.fleet_layout(gids1, 3, dev)
    if dr.fleet_chunks(layout1) < 2:
        raise AssertionError("B9 large groups: not chunked")
    per_stream = [dr.group_layout(gids1[b], 3, dev) for b in range(LIVE)]
    bitwise = {}  # B9 == K2 per stream, bit for bit, in each other aggregate
    for func in FLEET_FUNCS:
        cfg = dr.normalized_cfg(func, cfg0)
        args = (func, cfg, layout1, ts, vals, cnt, aggr, shift, min_ts, v0)
        got = dr.fleet_rollup_aggregate_tile(*args)
        want = dr.fleet_rollup_aggregate_tile_plain(*args)
        mean = dr.fleet_rollup_aggregate_tile_plain(
            func, cfg, layout1, ts, vals, cnt, torch.full_like(aggr, 2),
            shift, min_ts, v0) if func not in dr.COUNTER_FUNCS else None
        for b in range(LIVE):
            name = names[int(aggr[b])]
            e = aggr_close(f"B9 large groups {func} slot {b} {name}", name,
                           got[b], want[b], func,
                           None if mean is None else mean[b])
            if name not in ("stddev", "stdvar"):
                err["fleet_rollup_aggregate_tile"] = max(
                    err["fleet_rollup_aggregate_tile"], e)
        if not bool(torch.isfinite(got[:LIVE]).any()):
            raise AssertionError(f"B9 large groups {func}: no finite value")
        # K2 on each stream's tile, chunked by the same rule: count,
        # group, min and max bit for bit; whether the others come out bit
        # for bit too is recorded
        for name in dr.AGGR_FUNCS:
            code = torch.full_like(aggr, dr.FLEET_AGGR_CODES[name])
            got = dr.fleet_rollup_aggregate_tile(func, cfg, layout1, ts, vals,
                                                 cnt, code, shift, min_ts, v0)
            for b in range(LIVE):
                k2 = dr.rollup_aggregate_tile(func, name, ts[b], vals[b],
                                              cnt[b], per_stream[b], cfg,
                                              int(shift[b]), int(min_ts[b]))
                what = f"B9 large groups {func} slot {b} {name} vs K2"
                if name in ("count", "group", "min", "max"):
                    assert_equal(what, got[b], k2)
                else:
                    same = bool(torch.equal(got[b].view(torch.int64),
                                            k2.view(torch.int64)))
                    bitwise[name] = bitwise.get(name, True) and same
    # B10: a steady interval's columns, on rows near the capacity too
    K = 8
    new_ts = (ts.gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
              SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
    new_vals = torch.from_numpy(rng.normal(0, 1e3, (B, S, K))).to(dev)
    new_counts = torch.from_numpy(rng.integers(0, K + 1, (B, S))).to(
        device=dev, dtype=torch.int32)
    new_counts[0] = 0  # nothing staged for slot 0
    near = cnt.clone()
    near[4, ::3] = N - 3  # rows whose tail runs past the capacity
    got = dr.fleet_append_tile(ts.clone(), vals.clone(), near.clone(),
                               new_ts, new_vals, new_counts)
    want = dr.fleet_append_tile_plain(ts.clone(), vals.clone(), near.clone(),
                                      new_ts, new_vals, new_counts)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B10 {what}", g, w)
    # at K 16 and 24 (8 and 16 lanes a row: a refresh after a gap, a fleet
    # interval of 9 or more scrapes), from a generator of their own so the
    # checks after them see the same data
    krng = np.random.default_rng(1024)
    for K in (16, 24):
        new_ts = (ts.gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
                  SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
        new_vals = torch.from_numpy(krng.normal(0, 1e3, (B, S, K))).to(dev)
        new_counts = torch.from_numpy(krng.integers(0, K + 1, (B, S))).to(
            device=dev, dtype=torch.int32)
        new_counts[0] = 0
        new_counts[1] = K
        tail = cnt.clone()
        tail[4, 1::3] = N - K // 2
        got = dr.fleet_append_tile(ts.clone(), vals.clone(), tail.clone(),
                                   new_ts, new_vals, new_counts)
        want = dr.fleet_append_tile_plain(ts.clone(), vals.clone(),
                                          tail.clone(), new_ts, new_vals,
                                          new_counts)
        for g, w, what in zip(got, want, ("ts", "values", "counts")):
            assert_equal(f"B10 K={K} {what}", g, w)
    # and at the 30-minute resume's K (a warp a row)
    K = 120
    new_ts = (ts.gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
              SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
    new_vals = torch.from_numpy(rng.normal(0, 1e3, (B, S, K))).to(dev)
    new_counts = torch.from_numpy(rng.integers(0, K + 1, (B, S))).to(
        device=dev, dtype=torch.int32)
    new_counts[0] = 0
    new_counts[1] = K
    near[4, 1::3] = N - 60
    got = dr.fleet_append_tile(ts.clone(), vals.clone(), near.clone(),
                               new_ts, new_vals, new_counts)
    want = dr.fleet_append_tile_plain(ts.clone(), vals.clone(), near.clone(),
                                      new_ts, new_vals, new_counts)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B10 K={K} {what}", g, w)
    del got, want
    # B11: per-slot cutoffs; slots 2 and 5 are not compacted (cutoff 0),
    # yet every slot's live samples below 0 (the lookback prefix of the
    # cold tile's base) drop, as in the reference
    cut = torch.tensor([0 if b in (2, 5) else 420 * SCRAPE + b * 45_000
                        for b in range(B)], dtype=torch.int32, device=dev)
    got = dr.fleet_compact_tile(ts, vals, cnt, cut, cut)
    want = dr.fleet_compact_tile_plain(ts, vals, cnt, cut, cut)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B11 {what}", g, w)
    if not bool((got[2][2] < cnt[2]).any()):
        raise AssertionError("B11: a cutoff-0 slot kept its ts < 0")
    return err, bitwise, (cfg0, layout, ts, vals, cnt, aggr, shift, min_ts,
                          v0, gids, gids1)


def mesh_close(what, aggr, got, want, func="rate", mean=None) -> float:
    """A sharded aggregate against the unsharded one: count, group, min
    and max bit for bit (B13 folds its shards in row order), the others at
    aggr_close's tolerances (only the sums' association differs)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if aggr in ("count", "group", "min", "max"):
        return assert_exact(what, got, want)
    return aggr_close(what, aggr, got, want, func, mean)


def sequential_moments(aggr: str, rolled: torch.Tensor,
                       layout) -> torch.Tensor:
    """The moments [M, G, T] of a walk of each group's rows in ascending
    order, one add after another (the per-shard pass's order for a group
    of at most FLEET_CHUNK members)."""
    G, T = layout.num_groups, rolled.shape[1]
    order, starts = layout.order.long(), layout.starts.long()
    sizes = starts[1:] - starts[:-1]
    m = {"cnt": torch.zeros((G, T), dtype=torch.float64, device=rolled.device)}
    m["s1"], m["s2"] = torch.zeros_like(m["cnt"]), torch.zeros_like(m["cnt"])
    m["min"] = torch.full_like(m["cnt"], torch.inf)
    m["max"] = torch.full_like(m["cnt"], -torch.inf)
    for k in range(layout.max_group):
        v = rolled[order[(starts[:-1] + k).clamp(max=len(order) - 1)]]
        live = (k < sizes)[:, None] & ~torch.isnan(v)
        m["cnt"] = torch.where(live, m["cnt"] + 1.0, m["cnt"])
        m["s1"] = torch.where(live, m["s1"] + v, m["s1"])
        m["s2"] = torch.where(live, m["s2"] + v * v, m["s2"])
        m["min"] = torch.where(live & (v < m["min"]), v, m["min"])
        m["max"] = torch.where(live & (v > m["max"]), v, m["max"])
    return torch.stack([m[k] for k in dr.MOMENTS[aggr]])


def sharded_plain(mesh, func, aggr, shards, layouts, cfg, shift=0,
                  min_ts=dr.MIN_TS_NONE):
    """B13's plain version: each shard's plain moments, then the plain
    combine in shard order."""
    mom = torch.stack([dr.rollup_group_moments_plain(
        func, aggr, t, v, c, g, cfg, shift, min_ts)
        for t, v, c, g in zip(*shards, layouts)])
    return meshlib.combine_group_moments_plain(aggr, mom)


class _CountingLib:
    """A loaded kernel library whose vm_* calls count into `calls`."""

    def __init__(self, lib, calls: collections.Counter):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("vm_") or name == "vm_cuda_error_string":
            return fn

        def counted(*args):
            self._calls[name] += 1
            return fn(*args)
        return counted


def b15_phase_calls(step, parts) -> dict:
    """The C launchers one B15 call runs, with how often, and its host
    syncs (Tensor.item)."""
    calls = collections.Counter()
    libs = {n: kernels.lib(n) for n in ("mesh", "rollup")}
    item = torch.Tensor.item

    def counted_item(self):
        calls["syncs"] += 1
        return item(self)

    try:
        for n, h in libs.items():
            kernels._libs[n] = _CountingLib(h, calls)
        torch.Tensor.item = counted_item
        step(*parts)
    finally:
        kernels._libs.update(libs)
        torch.Tensor.item = item
    return dict(calls)


def check_b15_phases(what: str, func: str, step, parts, cards: int) -> dict:
    """One B15 call launches the halo pass, the row scan and the series
    pass once per card (the scratch pass at most once), and syncs with the
    host at most once (the counter funcs' irregular rows), whatever the
    shards a card holds."""
    got = b15_phase_calls(step, parts)
    want = {"vm_halo_compact": cards, "vm_time_shards_scan": cards,
            "vm_time_shards_series": cards}
    if {k: got.get(k, 0) for k in want} != want or \
            got.get("vm_time_shards_prep", 0) > cards or \
            got.get("syncs", 0) > (1 if func in dr.COUNTER_FUNCS else 0) or \
            set(got) - set(want) - {"vm_time_shards_prep", "syncs"}:
        raise AssertionError(f"{what}: launches {got}, want {want} on "
                             f"{cards} card(s)")
    return got


def check_halo_rows(what: str, mesh, parts, halo: int, cfg) -> dict:
    """B15's halo pass over the mesh's (one card's) shards against
    halo_compact_plain, row by row: a row read in place is its tile
    segment (halo then columns), every sample valid; a compacted row holds
    the plain compaction's valid prefix.  Both kinds must occur.  Returns
    the count of each."""
    ((dev, batch),) = meshlib.time_shard_batches(mesh)
    n_time = len(parts[0][0])
    T = dr.num_steps(cfg) // n_time
    out = torch.empty((sum(int(p[0].shape[0]) for p in parts[0]),
                       T * n_time), dtype=torch.float64, device=dev)
    shards = []
    for i, j in batch:
        H = min(halo, int(parts[0][i][j].shape[1])) if j else 0
        left = tuple(x[i][j - 1] for x in parts) if H else None
        shards.append(meshlib.TimeShard(*(x[i][j] for x in parts), left, H,
                                        0, out))
    hr = meshlib.halo_rows(shards)
    r0, n = 0, collections.Counter()
    for sh in shards:
        R, C = sh.ts.shape
        H = sh.halo
        hal = tuple(x[:, -H:] for x in sh.left) if H else (None,) * 3
        wt, wv, wc = meshlib.halo_compact_plain(*sh[:3], *hal, 0)
        rows = slice(r0, r0 + R)
        src = hr.src[rows].bool()
        assert_equal(f"B15 {what} counts", hr.counts[rows], wc)
        seg = [torch.cat([h, x], 1) if H else x for h, x in zip(hal, sh[:2])]
        live = torch.arange(H + C, device=dev)[None, :] < wc[:, None]
        for name, comp, s_, w in (("ts", hr.ts, seg[0], wt),
                                  ("values", hr.values, seg[1], wv)):
            g = torch.where(src[:, None], comp[rows, :H + C], s_)
            assert_equal(f"B15 {what} {name}", torch.where(live, g, 0),
                         torch.where(live, w, 0))
        # in place only where every sample is valid
        if not bool((wc[~src] == H + C).all()):
            raise AssertionError(f"B15 {what}: a row with a gap in place")
        n["in_place"] += int((~src).sum())
        n["compacted"] += int(src.sum())
        r0 += R
    if not n["in_place"] or not n["compacted"]:
        raise AssertionError(f"B15 {what}: one source only ({dict(n)})")
    return dict(n)


def kernels_mesh(dev, dash_planes, edge_planes, tile, ragged, bucket) -> dict:
    """B12-B15 against their plain versions and the unsharded kernels on
    the card, timed at the dashboard shape.  B12: every func on the edge
    planes (int8/16/32 d2), in shared memory and through the scratch
    path, bit for bit against K1 -> B5; B13: every func and aggregate on
    the ragged rows over 8 logical shards, unshifted and shifted, and the
    dashboard tile; B14: the fleet bucket of kernels_fleet over 4 stream
    shards, bit for bit against B9; B15: every func but lifetime on a
    (2, 4) mesh over the dashboard tile's columns, against B5 and its
    plain version."""
    res = {}
    S, G = DASH_SERIES, DASH_GROUPS
    ts_t, v_t, counts = tile
    start, end = dashboard_grid()
    dcfg0 = RollupConfig(start, end, DASH_STEP, WINDOW)
    cfg = dr.normalized_cfg("rate", dcfg0)
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    # B12
    err12 = 0.0
    rcfg0 = RollupConfig(T_START + 600_000, T_START + 9_000_000, 60_000,
                         WINDOW)
    for a, nc in edge_planes:
        k1 = dd.decode_tiles(*a, nc)
        for func in dr.FUNC_CODES:
            c = dr.normalized_cfg(func, rcfg0)
            want = dr.rollup_tile(func, *k1, a[7], c)
            for force in (False, True):
                got = dd.decode_and_rollup(func, *a, c, nc, force)
                assert_equal(f"B12 {func} {a[2].dtype} scratch {force}",
                             got, want)
            e = func_close(f"B12 {func} plain", func, got,
                           dd.decode_and_rollup_plain(func, *a, c, nc))
            if func in dr.COUNTER_FUNCS:
                err12 = max(err12, e)
    args, n_cap = dash_planes
    b12 = lambda: dd.decode_and_rollup(  # noqa: E731
        "rate", *args, cfg, n_cap)
    assert_equal("B12 dashboard", b12(),
                 dr.rollup_tile("rate", ts_t, v_t, counts, cfg))
    plane_bytes = sum(t.numel() * t.element_size() for t in args)
    res["decode_and_rollup"] = dict(
        max_abs_err=err12, ms=cuda_ms(b12),
        plain_ms=cuda_ms(lambda: dd.decode_and_rollup_plain(
            "rate", *args, cfg, n_cap), reps=3),
        library_ms=None,
        ms_scratch=cuda_ms(lambda: dd.decode_and_rollup(
            "rate", *args, cfg, n_cap, True)),
        ms_k1_then_b5=cuda_ms(lambda: dr.rollup_tile(
            "rate", *dd.decode_tiles(*args, n_cap), counts, cfg)),
        **bound(plane_bytes + S * T * 8, 2 * 2 * S * n_cap + 15 * S * T))

    # B13 over 8 logical shards
    mesh = meshlib.make_mesh(MESH_SHARDS, 1, [dev] * MESH_SHARDS)
    err13 = 0.0
    rg = len(ragged)
    pad = -(-rg // MESH_SHARDS) * MESH_SHARDS
    rgids = np.zeros(pad, np.int32)
    rgids[:rg] = np.arange(rg) * 7 % 4
    for off, mt in ((0, int(dr.MIN_TS_NONE)), (120_000, -420_000)):
        tsr, vr, cr = dr.pack_series(ragged, rcfg0.start - 600_000 - off)
        tsr = np.concatenate([tsr, np.full((pad - rg, tsr.shape[1]),
                                           dr.TS_PAD, np.int32)])
        vr = np.concatenate([vr, np.zeros((pad - rg, vr.shape[1]))])
        cr = np.concatenate([cr, np.zeros(pad - rg, np.int32)])
        whole = [torch.from_numpy(x).to(dev) for x in (tsr, vr, cr)]
        shards = [split_rows(mesh, "series", x) for x in whole]
        layouts = [dr.group_layout(g, 5, dev) for g in split_rows(
            mesh, "series", torch.from_numpy(rgids).to(dev))]
        flat = dr.group_layout(rgids, 5, dev)
        for func in dr.FUNC_CODES:
            if off and func in dr.TIME_VALUED_FUNCS:
                continue
            c = dr.normalized_cfg(func, RollupConfig(
                rcfg0.start - 600_000, rcfg0.start + 600_000, 60_000,
                WINDOW))
            mean = dr.rollup_aggregate_tile(func, "avg", *whole, flat, c,
                                            off, mt)
            for aggr in dr.AGGR_FUNCS:
                fn = meshlib.cached_sharded_rollup_aggregate(mesh, func, aggr,
                                                             c, 5)
                got = fn(*shards, layouts, off, mt)
                what = f"B13 {func}/{aggr} shift {off}"
                mesh_close(what, aggr, got, dr.rollup_aggregate_tile(
                    func, aggr, *whole, flat, c, off, mt), func, mean)
                e = aggr_close(f"{what} plain", aggr, got, sharded_plain(
                    mesh, func, aggr, shards, layouts, c, off, mt), func,
                    mean)
                if aggr not in ("stddev", "stdvar") and \
                        func in dr.COUNTER_FUNCS:
                    err13 = max(err13, e)
    shards = [split_rows(mesh, "series", x) for x in (ts_t, v_t, counts)]
    gids = torch.arange(S, device=dev).remainder(G).to(torch.int32)
    layouts = [dr.group_layout(g, G, dev)
               for g in split_rows(mesh, "series", gids)]
    flat = dr.group_layout(gids, G, dev)
    # by instance (32 rows a group, 4 a shard) and one group (1024 rows a
    # shard, which each shard walks in chunks and folds)
    zeros = torch.zeros(S, dtype=torch.int32, device=dev)
    for g_, lays, fl in ((G, layouts, flat), (1, [
            dr.group_layout(g, 1, dev) for g in split_rows(
                mesh, "series", zeros)], dr.group_layout(zeros, 1, dev))):
        for aggr in dr.AGGR_FUNCS:
            got = meshlib.sharded_rollup_aggregate(mesh, "rate", aggr, cfg,
                                                   g_)(*shards, lays)
            mesh_close(f"B13 dashboard {g_} groups {aggr}", aggr, got,
                       dr.rollup_aggregate_tile("rate", aggr, ts_t, v_t,
                                                counts, fl, cfg))
    # the shards of one card run one row scan and one moments pass: one
    # launch of the wrapper, whose moments are each shard's rows walked in
    # order one add after another (no shard holds more than FLEET_CHUNK
    # members of a group), bit for bit
    before = kernels.LAUNCHES["rollup_group_moments"]
    for aggr in ("sum", "stddev", "min", "max"):
        mom = dr.rollup_group_moments("rate", aggr, *shards, layouts, cfg)
        for d in range(MESH_SHARDS):
            assert_equal(f"B13 moments {aggr} shard {d}", mom[d],
                         sequential_moments(aggr, dr.rollup_tile(
                             "rate", *(x[d] for x in shards), cfg),
                             layouts[d]))
    if kernels.LAUNCHES["rollup_group_moments"] - before != 4:
        raise AssertionError("B13: the shards of one card took more than "
                             "one moments launch")
    b13 = meshlib.cached_sharded_rollup_aggregate(mesh, "rate", "sum", cfg,
                                                  G)
    res["sharded_rollup_aggregate"] = dict(
        max_abs_err=err13, ms=cuda_ms(lambda: b13(*shards, layouts)),
        plain_ms=cuda_ms(lambda: sharded_plain(
            mesh, "rate", "sum", shards, layouts, cfg), reps=3),
        library_ms=None, shards=MESH_SHARDS,
        k2_ms=cuda_ms(lambda: dr.rollup_aggregate_tile(
            "rate", "sum", ts_t, v_t, counts, flat, cfg)),
        **bound(n_valid * 12 + S * 12 + G * T * 8, 15 * S * T))

    # B14: kernels_fleet's bucket over 4 stream shards, and its bucket of
    # large groups (each shard's own layout chunks them as B9 does)
    (cfg0, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0, fgids,
     fgids1) = bucket
    fmesh = meshlib.make_fleet_mesh([dev] * 4)
    sh = {k: split_rows(fmesh, "stream", x) for k, x in (
        ("ts", fts), ("vals", fvals), ("cnt", fcnt), ("aggr", aggr),
        ("shift", shift), ("min_ts", min_ts), ("v0", v0))}
    flay = [dr.fleet_layout(g, G, dev)
            for g in split_rows(fmesh, "stream", fgids)]
    flay1 = [dr.fleet_layout(g, 3, dev)
             for g in split_rows(fmesh, "stream", fgids1)]
    layout1 = dr.fleet_layout(fgids1, 3, dev)
    names = {code: name for name, code in dr.FLEET_AGGR_CODES.items()}
    err14 = 0.0
    for func in FLEET_FUNCS:
        c = dr.normalized_cfg(func, cfg0)
        fn1 = meshlib.cached_fleet_rollup_aggregate(fmesh, func, c, 3)
        assert_equal(f"B14 {func} large groups", fn1(
            sh["ts"], sh["vals"], sh["cnt"], flay1, sh["aggr"], sh["shift"],
            sh["min_ts"], sh["v0"]), dr.fleet_rollup_aggregate_tile(
            func, c, layout1, fts, fvals, fcnt, aggr, shift, min_ts, v0))
        fn = meshlib.cached_fleet_rollup_aggregate(fmesh, func, c, G)
        got = fn(sh["ts"], sh["vals"], sh["cnt"], flay, sh["aggr"],
                 sh["shift"], sh["min_ts"], sh["v0"])
        args9 = (func, c, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0)
        assert_equal(f"B14 {func}", got, dr.fleet_rollup_aggregate_tile(
            *args9))
        want = dr.fleet_rollup_aggregate_tile_plain(*args9)
        for b in range(FLEET_LIVE):
            name = names[int(aggr[b])]
            e = aggr_close(f"B14 {func} slot {b}", name, got[b], want[b],
                           func)
            if name not in ("stddev", "stdvar"):
                err14 = max(err14, e)
    c = dr.normalized_cfg("rate", cfg0)
    fn = meshlib.cached_fleet_rollup_aggregate(fmesh, "rate", c, G)
    B, S9, _ = fts.shape
    T9 = dr.num_steps(c)
    res["cached_fleet_rollup_aggregate"] = dict(
        max_abs_err=err14, shards=4,
        ms=cuda_ms(lambda: fn(sh["ts"], sh["vals"], sh["cnt"], flay,
                              sh["aggr"], sh["shift"], sh["min_ts"],
                              sh["v0"]), reps=5),
        plain_ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile_plain(
            "rate", c, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0),
            reps=3),
        library_ms=None,
        b9_ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile(
            "rate", c, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0),
            reps=5),
        **bound(int(fcnt.sum()) * 12 + B * S9 * 20 + B * (G + 1) * 4 +
                B * 12 + B * G * T9 * 8, 15 * B * S9 * T9))

    # B15 over the dashboard tile's first DASH_SAMPLES columns, rebased to
    # the first scrape so the grid's chunks line up with the columns: gaps
    # in the first time shard, in the second one's halo (the first one's
    # tail) and in the second shard itself, so that both sources, rows
    # read in place and compacted rows, run on the card
    base = T_START - start
    ts15 = ts_t[:, :DASH_SAMPLES] - base
    v15 = v_t[:, :DASH_SAMPLES].contiguous()
    C15 = DASH_SAMPLES // B15_MESH[1]
    valid = torch.ones_like(ts15, dtype=torch.bool)
    valid[::7, 100:103] = False  # gaps
    valid[1::5, C15 - 5:C15 - 2] = False
    valid[2::9, C15 + 3] = False
    mesh15 = meshlib.make_mesh(*B15_MESH, [dev] * MESH_SHARDS)
    parts = [meshlib.split_2d(mesh15, x) for x in (ts15, v15, valid)]
    cfg15 = RollupConfig(0, DASH_SAMPLES * SCRAPE - B15_STEP, B15_STEP,
                         WINDOW)
    # B5's view of the same samples: the valid ones compacted per row
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    ts5 = torch.where(valid, ts15, int(dr.TS_PAD)).gather(1, order)
    v5 = torch.where(valid, v15, 0.0).gather(1, order)
    c5 = valid.sum(dim=1).to(torch.int32)
    err15 = 0.0
    for halo in (B15_HALO, C15):  # H = C: the halo is the whole shard
        for func in dr.FUNC_CODES:
            if func == "lifetime" or (halo == C15 and func not in (
                    "rate", "timestamp", "deriv", "stddev_over_time")):
                continue
            step = meshlib.time_sharded_rollup(mesh15, func, cfg15, halo)
            got = step(*parts)
            want = dr.rollup_tile(func, ts5, v5, c5, cfg15)
            if not bool(torch.isfinite(got).any()):
                raise AssertionError(f"B15 {func}: no finite value")
            # stddev/stdvar_over_time centre by the row mean, which a time
            # shard takes over its own samples (the reference's
            # semantics): they are held at the reference oracle's bound
            assert_close(f"B15 {func} halo {halo} vs B5", got, want,
                         *((1e-6, 1e-4) if func in dr.CENTRED_FUNCS
                           else (1e-9, 1e-9)))
            e = func_close(f"B15 {func} halo {halo} plain", func, got,
                           meshlib.time_sharded_rollup_plain(
                               mesh15, func, cfg15, halo)(*parts))
            if func in dr.COUNTER_FUNCS:
                err15 = max(err15, e)
        # one launch per phase for the card's 8 shards, at most one sync
        for func in ("rate", "timestamp"):
            check_b15_phases(f"B15 {func} halo {halo}", func,
                             meshlib.time_sharded_rollup(
                                 mesh15, func, cfg15, halo), parts, 1)
    # the halo pass itself: every row's source against the plain
    # transcription, both sources on the card
    halo15 = {h: check_halo_rows(f"halo {h}", mesh15, parts, h, cfg15)
              for h in (B15_HALO, C15)}
    step = meshlib.time_sharded_rollup(mesh15, "rate", cfg15, B15_HALO)
    T15 = dr.num_steps(cfg15)
    res["time_sharded_rollup"] = dict(
        max_abs_err=err15, mesh=list(B15_MESH), halo=B15_HALO,
        halo_rows=halo15,
        ms=cuda_ms(lambda: step(*parts)), device_ms=device_ms(
            lambda: step(*parts)),
        plain_ms=cuda_ms(lambda: meshlib.time_sharded_rollup_plain(
            mesh15, "rate", cfg15, B15_HALO)(*parts), reps=3),
        library_ms=None,
        b5_ms=cuda_ms(lambda: dr.rollup_tile("rate", ts5, v5, c5, cfg15)),
        **bound(S * DASH_SAMPLES * 13 + S * T15 * 8, 15 * S * T15))
    return res



def k1_edge_planes(rng, S: int, n: int, d2type, dev) -> list:
    """K1's arguments for S rows of n columns: random first values, first
    deltas and d2 entries of `d2type` in a plane 5 columns wider than
    n - 2; row 0 has count 0 and scale 1 (a mesh's padded row), row 1 a
    linear tail that wraps int32 at once, the rest counts in [0, n]."""
    info = np.iinfo(d2type)
    lo, hi = max(int(info.min), -2**20), min(int(info.max), 2**20)
    d2 = [rng.integers(lo, hi + 1, (S, max(n - 2, 1) + 5)).astype(d2type)
          for _ in range(2)]
    first = [rng.integers(-2**31, 2**31, S).astype(np.int32)
             for _ in range(4)]
    scale = 10.0 ** rng.integers(-6, 4, S).astype(np.float64)
    counts = rng.integers(0, n + 1, S).astype(np.int32)
    counts[0], scale[0] = 0, 1.0
    for x in first:
        x[1] = 2_000_000_000
    d2[0][1] = d2[1][1] = 0
    return [torch.from_numpy(a).to(dev) for a in (
        first[0], first[1], d2[0], first[2], first[3], d2[1], scale, counts)]


@contextlib.contextmanager
def k1_chunk(chunk: int):
    """decode_tiles inside the block cuts its rows in chunks of `chunk`
    columns, whatever k1_plan would pick."""
    keep = dd.k1_plan
    dd.k1_plan = lambda n, tb, vb, *_: dd.K1Plan(chunk,
                                                 dd.k1_smem(chunk, tb, vb))
    try:
        yield
    finally:
        dd.k1_plan = keep


def check_k1_edges(dev) -> None:
    """K1 bit for bit against its plain version at its edge rows: n of 1,
    2 and odd widths, each d2 width, planes wider than n - 2, count-0 rows
    and wrapping tails; planes at an offset from a 16-byte word; rows
    wider than one chunk (int32 planes at 7233 columns, which k1_plan cuts
    in two) and rows forced into other chunks, so b and x carry from chunk
    to chunk."""
    rng = np.random.default_rng(10)
    for n in (1, 2, 3, 5, 1857, 7233):
        for d2type in (np.int8, np.int16, np.int32):
            a = k1_edge_planes(rng, 64, n, d2type, dev)
            g, w = dd.decode_tiles(*a, n), dd.decode_tiles_plain(*a, n)
            what = f"K1 edge n={n} {d2type.__name__}"
            assert_equal(f"{what} ts", g[0], w[0])
            assert_equal(f"{what} values", g[1], w[1])
    if dd.k1_plan(7233, 4, 4, kernels.smem_per_sm(dev)).chunk >= 7233:
        raise AssertionError("K1: 7233 int32 columns are not chunked")
    # planes that start 1 to 15 bytes past a 16-byte word (views into a
    # buffer that ends with them): staged with no byte outside them
    for n, off in ((1857, 1), (38, 7), (7233, 15)):
        a = k1_edge_planes(rng, 64, n, np.int8, dev)
        for i in (2, 5):
            buf = torch.empty(off + a[i].numel(), dtype=torch.int8,
                              device=dev)
            a[i] = buf[off:].view(a[i].shape).copy_(a[i])
        g, w = dd.decode_tiles(*a, n), dd.decode_tiles_plain(*a, n)
        assert_equal(f"K1 planes at +{off} B, n={n} ts", g[0], w[0])
        assert_equal(f"K1 planes at +{off} B, n={n} values", g[1], w[1])
    a = k1_edge_planes(rng, 64, 1000, np.int16, dev)
    w = dd.decode_tiles_plain(*a, 1000)
    for chunk in (96, 7, 999, 1000):
        with k1_chunk(chunk):
            g = dd.decode_tiles(*a, 1000)
        assert_equal(f"K1 chunk {chunk} ts", g[0], w[0])
        assert_equal(f"K1 chunk {chunk} values", g[1], w[1])


def phase_kernels(rng, dev):
    """Each kernel against its plain version on the card: the dashboard
    shapes (timed), ragged edge-case rows and a fleet bucket.  Returns the
    timed kernels' results and the fleet kernels' largest differences."""
    res = {}
    # dashboard-shape inputs, the same generator the dashboard phase uses
    ts_h, vals_h = counters(rng, DASH_SERIES, DASH_SAMPLES, T_START)
    planes, n_cap = planes_for(zip(ts_h, vals_h), dashboard_grid()[0])
    args = plane_tensors(planes, dev)
    # K1
    got = dd.decode_tiles(*args, n_cap)
    want = dd.decode_tiles_plain(*args, n_cap)
    assert_equal("K1 ts", got[0], want[0])
    assert_equal("K1 values", got[1], want[1])
    edge_planes = []  # (plane tensors, columns), B12's edge rows too
    for jitter, incr in ((20, 30), (2_000, 5_000), (100_000, 2_000_000)):
        edge = []
        for i in range(64):
            n = 1 + i * 3
            t = np.sort(T_START + np.arange(n) * SCRAPE +
                        rng.integers(-jitter, jitter + 1, n))
            edge.append((t, np.cumsum(rng.integers(0, incr + 1, n)) / 100.0))
        p, nc = planes_for(edge, T_START)
        a = plane_tensors(p, dev)
        g, w = dd.decode_tiles(*a, nc), dd.decode_tiles_plain(*a, nc)
        assert_equal(f"K1 ts edge {p.ts_d2.dtype}", g[0], w[0])
        assert_equal(f"K1 values edge {p.val_d2.dtype}", g[1], w[1])
        edge_planes.append((a, nc))
    check_k1_edges(dev)
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    out_bytes = DASH_SERIES * n_cap * 12
    res["decode_tiles"] = dict(
        max_abs_err=0.0,  # bit-identical, checked above
        ms=cuda_ms(lambda: dd.decode_tiles(*args, n_cap)),
        plain_ms=cuda_ms(lambda: dd.decode_tiles_plain(*args, n_cap)),
        bytes=in_bytes + out_bytes, ops=2 * 2 * DASH_SERIES * n_cap)
    ts_t, v_t = got
    counts = args[7]

    # K2 at the dashboard shape: the cold query's launch, and a rolling
    # refresh's (grid advanced one scrape, the fetch bound gating)
    start, end = dashboard_grid()
    cfg = dr.normalized_cfg("rate", RollupConfig(start, end, DASH_STEP,
                                                 WINDOW))
    gids = (np.arange(DASH_SERIES) % DASH_GROUPS).astype(np.int32)
    groups = dr.group_layout(gids, DASH_GROUPS, dev)
    k2 = lambda: dr.rollup_aggregate_tile(  # noqa: E731
        "rate", "sum", ts_t, v_t, counts, groups, cfg)
    k2_plain = lambda: dr.rollup_aggregate_tile_plain(  # noqa: E731
        "rate", "sum", ts_t, v_t, counts, groups, cfg)
    out = k2()
    err2 = aggr_close("K2 dashboard", "sum", out, k2_plain())
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("K2 dashboard: non-finite group rates")
    # the same tile with a counter reset halfway along every 64th row and
    # a -0.0 on row 1: those rows take K2's scratch path, the rest read
    # the values directly
    rows = torch.arange(0, DASH_SERIES, 64, device=dev)
    mid = (counts[rows].long() // 2)[:, None]
    cols = torch.arange(n_cap, device=dev)[None, :]
    v_reset = v_t.clone()
    v_reset[rows] = torch.where(cols >= mid, v_t[rows] - v_t[rows].gather(
        1, mid), v_t[rows])
    v_reset[1, 0] = -0.0
    k2_resets = lambda: dr.rollup_aggregate_tile(  # noqa: E731
        "rate", "sum", ts_t, v_reset, counts, groups, cfg)
    err2 = max(err2, aggr_close(
        "K2 dashboard with resets", "sum", k2_resets(),
        dr.rollup_aggregate_tile_plain("rate", "sum", ts_t, v_reset, counts,
                                       groups, cfg)))
    roll = (SCRAPE, -(WINDOW + LOOKBACK_DELTA))
    err2 = max(err2, aggr_close(
        "K2 dashboard rolling", "sum",
        dr.rollup_aggregate_tile("rate", "sum", ts_t, v_t, counts, groups,
                                 cfg, *roll),
        dr.rollup_aggregate_tile_plain("rate", "sum", ts_t, v_t, counts,
                                       groups, cfg, *roll)))
    # every func x aggregate on the ragged rows, plain and shifted grids
    ragged = ragged_series(rng)
    rcfg0 = RollupConfig(T_START + 600_000, T_START + 1_800_000, 60_000,
                         WINDOW)
    rg = (np.arange(len(ragged)) * 7 % 4).astype(np.int32)
    rgroups = dr.group_layout(rg, 5, dev)
    for off, mt in ((0, int(dr.MIN_TS_NONE)), (120_000, -420_000)):
        tsr, vr, cr = (torch.from_numpy(a).to(dev) for a in dr.pack_series(
            ragged, rcfg0.start - off))
        for func in dr.FUNC_CODES:
            if off and func in dr.TIME_VALUED_FUNCS:
                continue  # they refuse a shifted grid
            rcfg = dr.normalized_cfg(func, rcfg0)
            mean = dr.rollup_aggregate_tile_plain(func, "avg", tsr, vr, cr,
                                                  rgroups, rcfg, off, mt)
            for aggr in dr.AGGR_FUNCS:
                g = dr.rollup_aggregate_tile(func, aggr, tsr, vr, cr,
                                             rgroups, rcfg, off, mt)
                w = dr.rollup_aggregate_tile_plain(func, aggr, tsr, vr, cr,
                                                   rgroups, rcfg, off, mt)
                if not bool(torch.isnan(g[4]).all()):
                    raise AssertionError("K2: the empty group is not NaN")
                e = aggr_close(f"K2 {func}/{aggr} shift {off}", aggr, g, w,
                               func, mean)
                if aggr not in ("stddev", "stdvar") and \
                        func in dr.COUNTER_FUNCS:
                    err2 = max(err2, e)
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    # K2's staged windows against B5's global searches: count, group, min
    # and max of rate (with resets too) and deriv, plain and rolling grids,
    # equal to B5's rows under the plain aggregate
    for func, vals in (("rate", v_t), ("rate", v_reset), ("deriv", v_t)):
        for sh, mt in ((0, int(dr.MIN_TS_NONE)), roll):
            rolled = dr.rollup_tile(func, ts_t, vals, counts, cfg, mt, sh)
            for aggr in ("count", "group", "min", "max"):
                assert_same_values(
                    f"K2 {func}/{aggr} shift {sh} vs B5",
                    dr.rollup_aggregate_tile(func, aggr, ts_t, vals, counts,
                                             groups, cfg, sh, mt),
                    dr.aggregate_groups(aggr, rolled, groups.gids,
                                        DASH_GROUPS))
    # K2 over groups it walks in chunks of R = FLEET_CHUNK: one group of
    # every series, and groups of exactly R, R + 1 and 2R + 1 members
    # beside one of the rest, members scattered over the tile; every
    # aggregate of rate: count, group, min and max equal to B5's rows
    # under the plain aggregate, the others against the chunked plain
    # version at aggr_close's tolerances
    R = dr.FLEET_CHUNK
    perm = rng.permutation(DASH_SERIES)
    edge = np.full(DASH_SERIES, 3, np.int32)
    edge[perm[:R]], edge[perm[R:2 * R + 1]] = 0, 1
    edge[perm[2 * R + 1:4 * R + 2]] = 2
    g_one = dr.group_layout(np.zeros(DASH_SERIES, np.int32), 1, dev)
    g_edge = dr.group_layout(edge, 4, dev)
    if g_edge.slots != 2 + 3 + -(-(DASH_SERIES - 4 * R - 2) // R):
        raise AssertionError(f"K2 chunk edges: {g_edge.slots} slots")
    rolled = dr.rollup_tile("rate", ts_t, v_t, counts, cfg)
    for what, lay in (("one group", g_one), ("R, R+1, 2R+1", g_edge)):
        for aggr in dr.AGGR_FUNCS:
            got = dr.rollup_aggregate_tile("rate", aggr, ts_t, v_t, counts,
                                           lay, cfg)
            if aggr in ("count", "group", "min", "max"):
                assert_same_values(f"K2 {what} {aggr} vs B5", got,
                                   dr.aggregate_groups(aggr, rolled, lay.gids,
                                                       lay.num_groups))
                continue
            e = aggr_close(f"K2 {what} {aggr}", aggr, got,
                           dr.rollup_aggregate_tile_plain(
                               "rate", aggr, ts_t, v_t, counts, lay, cfg))
            if aggr not in ("stddev", "stdvar"):
                err2 = max(err2, e)
    del rolled
    # sum(rate) over one group of every series: timed beside the
    # by-instance query (the same tile, 128 chunks of 64 rows)
    k2_one = lambda: dr.rollup_aggregate_tile(  # noqa: E731
        "rate", "sum", ts_t, v_t, counts, g_one, cfg)
    if not bool(torch.isfinite(k2_one()).all()):
        raise AssertionError("K2 dashboard one group: non-finite rates")
    res["rollup_aggregate_tile"] = dict(
        max_abs_err=err2, ms=cuda_ms(k2), plain_ms=cuda_ms(k2_plain, reps=3),
        ms_with_resets=cuda_ms(k2_resets),
        one_group={**three_ms(k2_one, n=10, reps=5), **bound(
            n_valid * 12 + DASH_SERIES * 12 + T * 8, 15 * DASH_SERIES * T)},
        bytes=n_valid * 12 + DASH_SERIES * 12 + DASH_GROUPS * T * 8,
        ops=15 * DASH_SERIES * T)

    # K3: one new scrape per series, K padded to 8 as _append_cols does
    K = 8
    new_ts = (ts_t.gather(1, (counts.long() - 1)[:, None]) + SCRAPE +
              torch.arange(K, device=dev, dtype=torch.int32)[None, :]
              * SCRAPE).to(torch.int32).contiguous()
    new_vals = torch.rand((DASH_SERIES, K), dtype=torch.float64, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
    new_counts = torch.ones(DASH_SERIES, dtype=torch.int32, device=dev)
    bufs = {}

    def fresh():
        for name, t in (("ts", ts_t), ("v", v_t), ("c", counts)):
            if name not in bufs:
                bufs[name] = torch.empty_like(t)
            bufs[name].copy_(t)

    def k3():
        dr.append_tile(bufs["ts"], bufs["v"], bufs["c"], new_ts, new_vals,
                       new_counts)

    fresh()
    k3()
    got = [bufs[k].clone() for k in ("ts", "v", "c")]
    plain = [t.clone() for t in (ts_t, v_t, counts)]
    dr.append_tile_plain(*plain, new_ts, new_vals, new_counts)
    for g, w, what in zip(got, plain, ("ts", "values", "counts")):
        assert_equal(f"K3 {what}", g, w)
    # edge rows: counts near the capacity, zero and full new counts
    ec = torch.randint(n_cap - 12, n_cap + 1, (DASH_SERIES,), device=dev,
                       dtype=torch.int32,
                       generator=torch.Generator(dev).manual_seed(2))
    enc = torch.randint(0, K + 1, (DASH_SERIES,), device=dev,
                        dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(3))
    a = [ts_t.clone(), v_t.clone(), ec.clone()]
    b = [ts_t.clone(), v_t.clone(), ec.clone()]
    dr.append_tile(*a, new_ts, new_vals, enc)
    dr.append_tile_plain(*b, new_ts, new_vals, enc)
    for g, w, what in zip(a, b, ("ts", "values", "counts")):
        assert_equal(f"K3 edge {what}", g, w)
    # bytes the function needs: each live new sample read and written
    # (12 B each way), counts read and written, new_counts read; the padded
    # columns past new_counts are never touched
    n_new = int(new_counts.sum())
    res["append_tile"] = dict(
        max_abs_err=0.0, ms=cuda_ms(k3, setup=fresh),
        plain_ms=cuda_ms(lambda: dr.append_tile_plain(
            bufs["ts"], bufs["v"], bufs["c"], new_ts, new_vals, new_counts),
            setup=fresh),
        bytes=n_new * 12 * 2 + DASH_SERIES * 12, ops=n_new)

    uploads = [
        upload_paths("refresh_columns", [new_ts.cpu().numpy(),
                                         new_vals.cpu().numpy(),
                                         new_counts.cpu().numpy()], dev),
        upload_paths("dashboard_planes", [
            getattr(planes, f) for f in ("ts_first", "ts_fdelta", "ts_d2",
                                         "val_first", "val_fdelta", "val_d2",
                                         "scale", "counts")], dev)]

    # K4: the resume refresh's slide (drops ~105 minutes of samples)
    cutoff = 420 * SCRAPE + 45_000
    for c in (cutoff, 0, 2**31 - 2):
        g = dr.compact_tile(ts_t, v_t, counts, c, c)
        w = dr.compact_tile_plain(ts_t, v_t, counts, c, c)
        for x, y, what in zip(g, w, ("ts", "values", "counts")):
            assert_equal(f"K4 {what} cutoff {c}", x, y)
    # bytes the function needs: each survivor read (12 B), only the
    # timestamp of each dropped sample (4 B), the whole [S, N] output
    # written (12 B per column), counts read and written
    survivors = int(dr.compact_tile_plain(ts_t, v_t, counts, cutoff,
                                          cutoff)[2].sum())
    dropped = n_valid - survivors
    res["compact_tile"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: dr.compact_tile(ts_t, v_t, counts, cutoff,
                                           cutoff)),
        plain_ms=cuda_ms(lambda: dr.compact_tile_plain(ts_t, v_t, counts,
                                                       cutoff, cutoff)),
        bytes=survivors * 12 + dropped * 4 + DASH_SERIES * n_cap * 12 +
        DASH_SERIES * 8,
        ops=DASH_SERIES * n_cap)
    res.update(kernels_slice2(rng, dev, ts_t, v_t, counts, ragged))
    fleet_err, b9_k2_bitwise, bucket = kernels_fleet(rng, dev, ts_t, v_t,
                                                     counts)
    res.update(kernels_mesh(dev, (args, n_cap), edge_planes,
                            (ts_t, v_t, counts), ragged, bucket))
    for r in res.values():
        r["bound_ms"] = max(r["bytes"] / MEM_BYTES_PER_S,
                            r["ops"] / SCALAR_OPS_PER_S) * 1e3
        r["bound_by"] = "bytes" if r["bytes"] / MEM_BYTES_PER_S >= \
            r["ops"] / SCALAR_OPS_PER_S else "operations"
    emit({"phase": "kernels", "ok": True,
          "shapes": {"series": DASH_SERIES, "tile_cols": n_cap,
                     "steps": T, "groups": DASH_GROUPS},
          "kernels": res, "fleet_max_abs_err": fleet_err,
          "b9_vs_k2_bitwise": b9_k2_bitwise,
          "uploads": uploads})
    return res, fleet_err


def _metric_sum(name: str) -> float:
    return float(sum(v for k, v in metricslib.REGISTRY.snapshot().items()
                     if k.startswith(name)))


# where a query's wall time goes: the engine's own transfer and kernel
# timers (each kernel call is timed to its completion on the card)
SPLIT = {
    "h2d": 'vm_device_transfer_duration_seconds_sum{span="device:upload"}',
    "d2h": 'vm_device_transfer_duration_seconds_sum{span="device:download"}',
    "k1": 'vm_tpu_kernel_duration_seconds_sum{kernel="decode_tiles"',
    "k2": 'vm_tpu_kernel_duration_seconds_sum{kernel="rollup_aggregate_tile"',
    "k3": 'vm_tpu_kernel_duration_seconds_sum{kernel="append_tile"',
    "k4": 'vm_tpu_kernel_duration_seconds_sum{kernel="compact_tile"',
}


def split_snapshot() -> dict[str, float]:
    return {k: _metric_sum(n) for k, n in SPLIT.items()}


def split_ms(before: dict, after: dict, wall_s: float,
             extra: dict | None = None) -> dict[str, float]:
    """Per-layer ms between two snapshots; `host_ms` is the rest of the
    wall time (host packing and glue), `kernel_share` the kernels' part of
    the wall time (an upper bound on the card's busy share: each kernel
    call is timed from its launch to its completion)."""
    out = {f"{k}_ms": (after[k] - before[k]) * 1e3 for k in SPLIT}
    for k, v in (extra or {}).items():
        out[f"{k}_ms"] = v * 1e3
    out["host_ms"] = wall_s * 1e3 - sum(out.values())
    out["kernel_share"] = sum(after[k] - before[k] for k in
                              ("k1", "k2", "k3", "k4")) / wall_s
    return out


# the dashboard's other panels on the cold query's resident tile: (field,
# entry point, arguments after the engine); each is held against the same
# entry point on a CPU engine, which runs the plain versions
# kernels each slice-2 query must launch on the card
QUERY_KERNELS = {
    "rate": ("rollup_tile",),
    "topk": ("rollup_tile", "topk_select_tile", "take_rows"),
    "bottomk": ("rollup_tile", "topk_select_tile", "take_rows"),
    "topk_avg": ("rollup_tile", "rank_tile", "take_rows"),
    "topk_median": ("rollup_tile", "rank_tile", "take_rows"),
    "topk_last": ("rollup_tile", "rank_tile", "take_rows"),
    "quantile_by_instance": ("rollup_tile", "rollup_quantile_tile"),
    "median": ("rollup_tile", "rollup_quantile_tile"),
    "avg_deriv_by_instance": ("rollup_aggregate_tile",),
    "instant_quantile": ("rollup_tile", "rollup_quantile_tile"),
}


def check_launched(where: str, name: str, launches: dict) -> None:
    missing = [k for k in QUERY_KERNELS[name] if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{where} {name}: {missing} not launched")


def dashboard_panels(engine, series, cfg, key, gids) -> dict:
    """Per-series rates, top/bottom 10, the topk_<kind> rankings and the
    quantile panels as cold queries on the resident tile: wall ms, launches
    and the largest difference from the plain versions, per query."""
    S, G = len(series), DASH_GROUPS
    _, max_group = ce.group_slots(gids, G)
    ones = np.zeros(S, np.int32)
    queries = {
        "rate": (ce.try_rollup, ("rate", series, cfg, ())),
        "topk": (ce.try_topk_rollup, ("topk", 10, "rate", series, cfg)),
        "bottomk": (ce.try_topk_rollup, ("bottomk", 10, "rate", series,
                                         cfg)),
        "topk_avg": (ce.try_topk_rollup, ("topk_avg", 10, "rate", series,
                                          cfg)),
        "topk_median": (ce.try_topk_rollup, ("topk_median", 10, "rate",
                                             series, cfg)),
        "topk_last": (ce.try_topk_rollup, ("topk_last", 10, "rate", series,
                                           cfg)),
        "quantile_by_instance": (ce.try_quantile_rollup, (
            0.9, "rate", series, gids, G, cfg, max_group)),
        "median": (ce.try_quantile_rollup, (0.5, "rate", series, ones, 1,
                                            cfg, S)),
    }
    cpu = ce.CUDAEngine(device="cpu")
    cpu.cache().put_device(key, tuple(t.cpu() for t in
                                      engine.cache().get(key)))
    out = {}
    for name, (fn, args) in queries.items():
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = fn(engine, *args, cache_key=key)
        wall = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0)
                    for k, v in kernels.LAUNCHES.items()
                    if v != before.get(k, 0)}
        check_launched("dashboard", name, launches)
        want = fn(cpu, *args, cache_key=key)
        if got is None or want is None:
            raise AssertionError(f"dashboard {name}: declined")
        if fn is ce.try_topk_rollup:
            if [i for i, _ in got] != [i for i, _ in want] or not got:
                raise AssertionError(f"dashboard {name}: other series")
            got = np.stack([r for _, r in got])
            want = np.stack([r for _, r in want])
        got, want = np.asarray(got), np.asarray(want)
        if not np.isfinite(got).any():
            raise AssertionError(f"dashboard {name}: no finite value")
        err = assert_close(f"dashboard {name}", torch.from_numpy(got),
                           torch.from_numpy(want), 1e-12, 0.0)
        out[name] = {"ms": wall * 1e3, "shape": list(got.shape),
                     "launches": launches, "max_abs_err_vs_plain": err}
    return out


#: the dashboard's panels as query text, each served on the card through
#: the port's evaluator (exec_query) and held against its host evaluator
PANEL_TEXTS = {
    "sum_by_instance": f"sum by (instance)(rate({SELECTOR}[5m]))",
    "rate": f"rate({SELECTOR}[5m])",
    "topk": f"topk(10, rate({SELECTOR}[5m]))",
    "bottomk": f"bottomk(10, rate({SELECTOR}[5m]))",
    "topk_avg": f"topk_avg(10, rate({SELECTOR}[5m]))",
    "topk_median": f"topk_median(10, rate({SELECTOR}[5m]))",
    "topk_last": f"topk_last(10, rate({SELECTOR}[5m]))",
    "quantile_by_instance":
        f"quantile(0.9, rate({SELECTOR}[5m])) by (instance)",
    "median": f"median(rate({SELECTOR}[5m]))",
}
#: the host evaluator's bound for quantile and median: the reference's own
#: for its fused quantile against its host path
#: (tests/test_device_rollup.py test_fused_matches_host, rtol 1e-6, atol
#: 1e-6)
QUANTILE_TOL = (1e-6, 1e-6)
#: the kernels each panel's route launches on the card when the
#: evaluator serves it cold on a fresh engine: the first panel uploads the
#: selector's tile (K1), the others find it in the engine's tile cache
ORACLE_KERNELS = {"sum_by_instance": ("decode_tiles",
                                      "rollup_aggregate_tile"),
                  **{p: QUERY_KERNELS[p] for p in PANEL_TEXTS
                     if p != "sum_by_instance"}}
#: the route each panel takes through the evaluator
PANEL_ROUTES = {"sum_by_instance": "fused cold (K1, K2)",
                "rate": "per-series (B5)",
                "topk": "topk (B5, B6, take_rows)",
                "bottomk": "topk (B5, B6, take_rows)",
                "topk_avg": "topk_<kind> (B5, B7, take_rows)",
                "topk_median": "topk_<kind> (B5, B7, take_rows)",
                "topk_last": "topk_<kind> (B5, B7, take_rows)",
                "quantile_by_instance": "fused quantile (B5, B8)",
                "median": "fused quantile (B5, B8)"}
#: the rolling queries served through the evaluator after each refresh
ROLL_TEXTS = {"sum": PANEL_TEXTS["sum_by_instance"],
              "quantile": PANEL_TEXTS["quantile_by_instance"]}


def evaluator_ec(store, engine, start: int, end: int, **kw) -> EvalConfig:
    """The serving front end's evaluation context for a dashboard query
    (the reference's PrometheusAPI._ec): its lookback delta, series limit
    and the engine as ``tpu``."""
    return EvalConfig(start=start, end=end, step=DASH_STEP, storage=store,
                      lookback_delta=LOOKBACK_DELTA, max_series=MAX_SERIES,
                      tpu=engine, **kw)


def launched_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
            if v != before.get(k, 0)}


def rows_by_name(what: str, got, want, rtol: float, atol: float) -> float:
    """Two exec_query results: the same series in the same order (by
    marshalled name), values at (rtol, atol), NaN where the other has NaN;
    the largest difference."""
    gn = [bytes(ts.metric_name.marshal()) for ts in got]
    wn = [bytes(ts.metric_name.marshal()) for ts in want]
    if gn != wn or not gn:
        raise AssertionError(f"{what}: other series ({len(gn)} vs "
                             f"{len(wn)})")
    g = np.stack([ts.values for ts in got])
    w = np.stack([ts.values for ts in want])
    if not np.isfinite(g).any():
        raise AssertionError(f"{what}: no finite value")
    return assert_close(what, torch.from_numpy(g), torch.from_numpy(w),
                        rtol, atol)


def by_group(what: str, rows, group_keys) -> np.ndarray:
    """An exec_query result grouped by instance as a [G, T] array in the
    direct path's group order (group_keys from instance_groups)."""
    at = {(("instance", ts.metric_name.get_label(b"instance").decode()),):
          ts.values for ts in rows}
    if set(at) != set(group_keys):
        raise AssertionError(f"{what}: other groups")
    return np.stack([at[k] for k in group_keys])


def evaluator_check(dev, store, grid) -> tuple[dict, object]:
    """The dashboard's nine panels from their text through exec_query on
    the dashboard's store and grid: first on the card (a fresh CUDAEngine,
    so every route runs cold; each panel must launch its route's kernels,
    ORACLE_KERNELS, none means the evaluator declined to the host), then
    through the port's host evaluator (tpu=None) as the oracle, with the
    rollup result cache emptied between, so that no card row serves the
    oracle: sums and rates at rtol 1e-12, the selections' series the same
    and their values at 1e-12, quantile and median at QUANTILE_TOL.  Then
    sum by (instance) again unchanged: the warm aux path, one K2 launch,
    no K1 and no store fetch.  Returns the check's line and the engine,
    which holds the evaluator's rolling windows for the refreshes."""
    start, end = grid
    rrc.GLOBAL.reset()
    engine = ce.CUDAEngine(device=dev)
    card, out, costs = {}, {}, {}
    t_all = time.perf_counter()
    for panel, q in PANEL_TEXTS.items():
        t0 = time.perf_counter()
        e = parse_cached(q)
        parse_ms = (time.perf_counter() - t0) * 1e3
        ec = evaluator_ec(store, engine, start, end)
        before, f0 = dict(kernels.LAUNCHES), fetch_s()
        t0 = time.perf_counter()
        card[panel] = exec_query(ec, q)
        exec_ms = (time.perf_counter() - t0) * 1e3
        launches = launched_since(before)
        want = ORACLE_KERNELS[panel]
        if not all(launches.get(k) for k in want) or (
                panel != "sum_by_instance" and launches.get("decode_tiles")):
            raise AssertionError(f"evaluator {q!r} launched {launches}, not "
                                 f"its route's {want}")
        if panel == "sum_by_instance":
            costs["cold"] = ec.cost.summary()
        out[panel] = {"q": str(e), "route": PANEL_ROUTES[panel],
                      "parse_ms": parse_ms, "exec_ms": exec_ms,
                      "fetch_ms": (fetch_s() - f0) * 1e3,
                      "launches": launches}
    card_ms = (time.perf_counter() - t_all) * 1e3
    rrc.GLOBAL.reset()
    t0 = time.perf_counter()
    host = {panel: exec_query(evaluator_ec(store, None, start, end), q)
            for panel, q in PANEL_TEXTS.items()}
    oracle_ms = (time.perf_counter() - t0) * 1e3
    rrc.GLOBAL.reset()
    for panel, q in PANEL_TEXTS.items():
        tol = QUANTILE_TOL if panel in ("quantile_by_instance", "median") \
            else (1e-12, 0.0)
        err = rows_by_name(f"evaluator {q!r} card vs host", card[panel],
                           host[panel], *tol)
        out[panel].update(max_abs_err=err, rtol=tol[0], atol=tol[1],
                          series=len(card[panel]),
                          shape=[len(card[panel]),
                                 int(card[panel][0].values.size)])
    # the same query again on unchanged data: the warm aux path
    ec = evaluator_ec(store, engine, start, end)
    before, ph0 = dict(kernels.LAUNCHES), fetch_phases()
    t0 = time.perf_counter()
    warm = exec_query(ec, PANEL_TEXTS["sum_by_instance"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_launches = launched_since(before)
    if warm_launches != {"rollup_aggregate_tile": 1} or \
            fetch_phases() != ph0:
        raise AssertionError(f"evaluator warm repeat: {warm_launches}, "
                             f"fetch {phases_ms(ph0, fetch_phases())}")
    costs["warm"] = ec.cost.summary()
    rows_by_name("evaluator warm repeat vs cold", warm,
                 card["sum_by_instance"], 0.0, 0.0)
    emit({"check": "evaluator_cost", "query": PANEL_TEXTS["sum_by_instance"],
          **costs})
    res = {"check": "evaluator", "ok": True, "panels": out,
           "card_ms": card_ms, "oracle_ms": oracle_ms,
           "warm": {"exec_ms": warm_ms, "launches": warm_launches,
                    "fetch_phases_unchanged": True}}
    emit(res)
    return res, engine


def trace_messages(trace: dict) -> list[str]:
    """Every span's message of a trace's dict form (what a query over HTTP
    returns with trace=1)."""
    todo, msgs = [trace], []
    while todo:
        d = todo.pop()
        msgs.append(d.get("message", ""))
        todo.extend(d.get("children", ()))
    return msgs


_ROUTE_MSGS = (
    (re.compile(r"fused tail kernel \+ D2H: \[\d+, (\d+)\] tail, (\d+) "
                r"columns reused"), "ring tail"),
    (re.compile(r"pure shift: (\d+) columns reused"), "pure shift"),
    (re.compile(r"fused kernel \+ D2H: \[\d+, (\d+)\]"), "advanced"),
    (re.compile(r"not advanceable \((.*)\); rebuilding"), "rebuild"),
)


def roll_route(tracer) -> dict:
    """The route the evaluator's trace of one rolling query records: the
    ring's tail (the new columns computed, the rest reused), a pure shift
    (every column reused), a full grid on the advanced tile, or a rebuild
    (the reason the advance declined)."""
    msgs = trace_messages(tracer.to_dict())
    found = {}
    for rx, route in _ROUTE_MSGS:
        for m in msgs:
            hit = rx.search(m)
            if hit:
                found.setdefault(route, hit.groups())
    if "rebuild" in found:
        return {"route": "rebuild", "reason": found["rebuild"][0]}
    if "ring tail" in found:
        n, reused = found["ring tail"]
        return {"route": "ring tail", "columns": int(n),
                "reused": int(reused)}
    if "pure shift" in found:
        return {"route": "pure shift", "reused": int(found["pure shift"][0])}
    if "advanced" in found:
        return {"route": "advanced", "columns": int(found["advanced"][0])}
    raise AssertionError(f"no rolling route in the trace: {msgs}")


def evaluator_refresh(engine, cold_engine, store, start, end, direct,
                      group_keys, beside) -> dict:
    """One dashboard refresh through the evaluator: sum by (instance) and
    quantile(0.9) by (instance) from their text through exec_query on the
    evaluator's own rolling window (advance_rolling and the ring of the
    [G, T] result), each held at rtol 1e-12 against the direct path's
    served result of this refresh and against a cold exec_query with
    disable_cache (its launches left out of the path's counts); the
    route from the evaluator's trace, with the launches it made."""
    out = {}
    for name, q in ROLL_TEXTS.items():
        tracer = querytracer.Tracer("refresh %s", name)
        ec = evaluator_ec(store, engine, start, end, tracer=tracer)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        rows = exec_query(ec, q)
        exec_ms = (time.perf_counter() - t0) * 1e3
        launches = launched_since(before)
        route = roll_route(tracer)
        with beside():
            cold = exec_query(evaluator_ec(store, cold_engine, start, end,
                                           disable_cache=True), q)
        err = assert_close(f"evaluator {name} refresh vs the direct path",
                           torch.from_numpy(by_group(q, rows, group_keys)),
                           torch.from_numpy(np.asarray(direct[name])),
                           1e-12, 0.0)
        err_cold = rows_by_name(f"evaluator {name} refresh vs cold", rows,
                                cold, 1e-12, 0.0)
        out[name] = {**route, "exec_ms": exec_ms, "launches": launches,
                     "vs_direct_max_abs_err": err,
                     "vs_cold_max_abs_err": err_cold,
                     "decline": engine.last_roll_decline}
    cold_engine.cache().invalidate()
    return out


def dashboard_keys():
    """The dashboard query's roll-state and roll-tile keys."""
    return ce.device_roll_keys(SELECTOR, TENANT, "rate", "sum", None,
                               ("instance",), False, None, WINDOW)


def build_store(rng, stores: Stores) -> dict:
    """The dashboard's store, built through the columnar write path: the
    seeded counters (8192 x 1440) into a new Storage through
    add_rows_columnar, 40 whole scrapes a call; then flushed and closed,
    copied for the mesh phase's replay, and both reopened.  (The
    refreshes' scrapes go in through add_rows, so both write paths run.)
    Before any query, the store's columns are held against the seeded
    ones exactly (row order: the store's, by
    marshaled name).  The refreshes' scrapes are made here too, so that
    both stores get the same ones."""
    S = DASH_SERIES
    labels = dash_labels(S)
    ts, vals = counters(rng, S, DASH_SAMPLES, T_START)
    feed = Feed(int(rng.integers(2**62)), vals[:, -1])
    end = dashboard_grid()[1]
    batches = []
    for k, adv in DASH_REFRESHES:
        batches.append(feed.next(k, end))
        end += adv
    store = stores.open("dashboard")
    ingest_s = ingest_columnar(store, series_keys(labels), ts, vals)
    if columnar_keys(store) != S:
        raise AssertionError("store: the columnar space does not hold "
                             "every series")
    t0 = time.perf_counter()
    stores.close(store)
    close_s = time.perf_counter() - t0
    on_disk = disk_bytes(stores.path("dashboard"))
    t0 = time.perf_counter()
    shutil.copytree(stores.path("dashboard"), stores.path("replay"))
    copy_s = time.perf_counter() - t0
    # the http phase's server opens its own copy (not through Stores),
    # which the satellites phase's server reopens
    shutil.copytree(stores.path("dashboard"), stores.path("http"))
    http_feed = copy.deepcopy(feed)
    http_feed.history = []
    t0 = time.perf_counter()
    store, replay = stores.open("dashboard"), stores.open("replay")
    open_s = time.perf_counter() - t0
    # the seeded columns in the store's row order, named independently
    raws = [MetricName.from_dict(lb).marshal() for lb in labels]
    order = sorted(range(S), key=raws.__getitem__)
    f0 = fetch_s()
    t0 = time.perf_counter()
    cols = store.search_columns(FILTERS, T_START - DAY, T_START + DAY,
                                tenant=TENANT)
    search_s = time.perf_counter() - t0
    names = [raws[i] for i in order]
    if cols.raw_names != names:
        raise AssertionError("store: other series or another row order")
    if not (np.array_equal(cols.counts, np.full(S, DASH_SAMPLES)) and
            np.array_equal(cols.ts, ts[order]) and
            np.array_equal(cols.vals.view(np.int64),
                           vals[order].view(np.int64))):
        raise AssertionError("store: columns differ from the seeded ones")
    n_rows = S * DASH_SAMPLES
    return {"store": store, "replay": replay, "labels": labels,
            "seeded": (ts[order], vals[order]), "names": names,
            "batches": batches,
            "feed": feed, "http": {"path": stores.path("http"),
                                   "labels": labels, "feed": http_feed,
                                   "tail": (ts[:, -SAT_TAIL:],
                                            vals[:, -SAT_TAIL:])},
            "info": {
                "anchor_ms": T_START, "series": S, "rows": n_rows,
                "write_path": "add_rows_columnar",
                "scrapes_per_call": SCRAPES_PER_CALL,
                "ingest_s": ingest_s, "rows_per_s": n_rows / ingest_s,
                "close_s": close_s, "disk_bytes": on_disk,
                "copy_s": copy_s, "open_s": open_s,
                "columns_search_ms": search_s * 1e3,
                "columns_fetch_ms": (fetch_s() - f0) * 1e3,
                "columns_equal_seeded": True}}


def seeded_k2(dev, built, series, lo, hi, gids, G, cfg) -> np.ndarray:
    """K2 on the seeded series handed straight to the engine, in the
    store's row order, clipped to the query's fetch range [lo, hi]: the
    cold query through the store must equal it bit for bit."""
    if [sd.raw_name for sd in series] != built["names"]:
        raise AssertionError("store: the cold query's series differ from "
                             "the seeded ones")
    ts, vals = built["seeded"]
    direct = []
    for i in range(ts.shape[0]):
        keep = (ts[i] >= lo) & (ts[i] <= hi)
        direct.append(SeriesData(None, ts[i][keep], vals[i][keep],
                                 raw_name=b"seeded-%d" % i))
    return ce.try_aggr_rollup(ce.CUDAEngine(device=dev), "sum", "rate",
                              direct, gids, G, cfg)


def phase_dashboard(rng, dev, stores: Stores):
    """The main path on the port's Storage: the store built through
    add_rows_columnar and checked, the cold query from
    store.search_series (held bit for bit against K2 on the seeded
    series), then rolling refreshes
    reading the store, each held against a cold rebuild.  Returns the
    phase's result and the state the fleet phase continues from (store,
    engine, groups, the last end, the feed of new scrapes)."""
    S, G = DASH_SERIES, DASH_GROUPS
    built = build_store(rng, stores)
    store, batches = built["store"], built["batches"]
    start, end = dashboard_grid()
    fetch_lo = start - WINDOW - LOOKBACK_DELTA
    engine = ce.CUDAEngine(device=dev)
    kernels.reset_launches()
    rebuild_launches = collections.Counter()

    @contextlib.contextmanager
    def beside():
        """Launches of the comparisons, left out of the path's counts."""
        before = dict(kernels.LAUNCHES)
        try:
            yield
        finally:
            for name, n in kernels.LAUNCHES.items():
                rebuild_launches[name] += n - before.get(name, 0)

    def cold(start_ms, end_ms, eng, key=None):
        series = store.search_series(FILTERS, start_ms - WINDOW -
                                     LOOKBACK_DELTA, end_ms, tenant=TENANT)
        gids, keys = instance_groups(series)
        cfg = RollupConfig(start_ms, end_ms, DASH_STEP, WINDOW)
        return ce.try_aggr_rollup(eng, "sum", "rate", series, gids,
                                  len(keys), cfg, cache_key=key), \
            series, gids, keys

    ver0 = store.data_version
    up0 = tile_cache.bytes_uploaded()
    snap, f0 = split_snapshot(), fetch_s()
    t0 = time.perf_counter()
    key = ("dashboard", start, ver0)
    out, series, gids, group_keys = cold(start, end, engine, key)
    cold_s = time.perf_counter() - t0
    cold_ms = cold_s * 1e3
    cold_fetch = fetch_s() - f0
    cold_split = split_ms(snap, split_snapshot(), cold_s,
                          {"fetch": cold_fetch})
    cold_up = tile_cache.bytes_uploaded() - up0
    T = (end - start) // DASH_STEP + 1
    if len(group_keys) != G or len(series) != S:
        raise AssertionError(f"dashboard: {len(series)} series in "
                             f"{len(group_keys)} groups from the store")
    if out is None or out.shape != (G, T) or not np.isfinite(out).all():
        raise AssertionError("dashboard cold query: wrong or non-finite "
                             "result")
    cfg0 = RollupConfig(start, end, DASH_STEP, WINDOW)
    with beside():
        direct = seeded_k2(dev, built, series, start - WINDOW -
                           LOOKBACK_DELTA, end, gids, G, cfg0)
    assert_exact("dashboard cold K2 through the store vs on the seeded "
                 "series", torch.from_numpy(out), torch.from_numpy(direct))
    panels = dashboard_panels(engine, series, cfg0, key, gids)
    t0 = time.perf_counter()
    evaluator, eval_engine = evaluator_check(dev, store, (start, end))
    evaluator["seconds"] = time.perf_counter() - t0
    cold_engine = ce.CUDAEngine(device=dev)
    _, max_group = ce.group_slots(gids, G)
    skey, tkey = dashboard_keys()
    rt = ce.register_window(
        engine, skey, tkey, gids, group_keys, tile_key=key, series=series,
        cfg=cfg0, fetch_info=(fetch_lo, end, ver0),
        structural=store.structural_version)
    if rt is None:
        raise AssertionError("dashboard: the rolling window was not filed")
    refresh_ms, refresh_up, refresh_split, worst = [], [], [], 0.0
    quantile_ms, worst_q, served_all, ingest_ms = [], 0.0, [], []
    refresh_phases, eval_refreshes = [], []
    eval_s = 0.0
    compactions0 = _metric_sum("vm_device_window_compactions_total")
    for (k, adv), batch in zip(DASH_REFRESHES, batches):
        ingest_ms.append(ingest(store, built["labels"], *batch) * 1e3)
        start, end = start + adv, end + adv
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        up0 = tile_cache.bytes_uploaded()
        snap, f0, ph0 = split_snapshot(), fetch_s(), fetch_phases()
        t0 = time.perf_counter()
        rt, groups, *_ = engine.window_cache().get(skey)
        if not ce.advance_rolling(engine, rt, store, FILTERS, start,
                                  fetch_lo, end, None, TENANT, True):
            raise AssertionError("rolling refresh declined: "
                                 + engine.last_roll_decline)
        cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
        served = ce.run_fused_on_tiles(engine, "sum", "rate", rt.tiles,
                                       groups, cfg, start - rt.base_ms,
                                       fetch_lo - start)
        wall = time.perf_counter() - t0
        refresh_ms.append(wall * 1e3)
        served_all.append(served)
        refresh_up.append(tile_cache.bytes_uploaded() - up0)
        refresh_split.append(split_ms(snap, split_snapshot(), wall,
                                      {"fetch": fetch_s() - f0}))
        refresh_phases.append(phases_ms(ph0, fetch_phases()))
        tile_cache.count_window_hit()
        # the quantile panel on the same refreshed tile, timed on its own
        t0 = time.perf_counter()
        served_q = ce.run_quantile_on_tiles(engine, 0.9, "rate", rt.tiles,
                                            groups, cfg, start - rt.base_ms,
                                            fetch_lo - start)
        quantile_ms.append((time.perf_counter() - t0) * 1e3)
        with beside():
            eng2 = ce.CUDAEngine(device=dev)
            rebuilt, series2, gids2, _ = cold(start, end, eng2)
            if not np.array_equal(gids2, gids):
                raise AssertionError("rebuild: other groups")
            rebuilt_q = ce.try_quantile_rollup(eng2, 0.9, "rate", series2,
                                               gids, G, cfg, max_group)
        worst = max(worst, assert_close("served == cold", served, rebuilt,
                                        1e-12, 0.0))
        if not np.isfinite(served_q).all():
            raise AssertionError("rolling quantile: non-finite result")
        worst_q = max(worst_q, assert_close(
            "served quantile == cold", served_q, rebuilt_q, 1e-12, 0.0))
        t0 = time.perf_counter()
        ev = evaluator_refresh(eval_engine, cold_engine, store, start, end,
                               {"sum": served, "quantile": served_q},
                               group_keys, beside)
        eval_s += time.perf_counter() - t0
        for name, r in ev.items():
            if r["route"] == "rebuild":
                raise AssertionError(f"evaluator {name} refresh of {k} "
                                     f"scrapes rebuilt: {r['reason']}")
            # the sum advances the shared tile (K3); the quantile after it
            # finds it advanced
            appended = r["launches"].get("append_tile", 0) > 0
            if k == 1 and (r["launches"].get("decode_tiles") or
                           appended != (name == "sum")):
                raise AssertionError(f"evaluator {name}: a one-scrape "
                                     f"refresh launched {r['launches']}")
        eval_refreshes.append({"scrapes": k, **ev})
    del eval_engine, cold_engine
    launches = {name: kernels.LAUNCHES.get(name, 0) -
                rebuild_launches.get(name, 0) for name in SOURCES
                if name not in FLEET_KERNELS + MESH_KERNELS}
    compactions = _metric_sum("vm_device_window_compactions_total") - \
        compactions0
    steady = [u for (k, _), u in zip(DASH_REFRESHES, refresh_up) if k == 1]
    if compactions < 1:
        raise AssertionError("no refresh slid the window (compact_window)")
    if max(steady) * 20 > cold_up:
        raise AssertionError("steady refreshes uploaded too much")
    res = {"phase": "dashboard", "ok": True, "series": S, "groups": G,
           "steps": T, "store": built["info"], "cold_ms": cold_ms,
           "cold_upload_bytes": cold_up, "cold_split": cold_split,
           "cold_bitwise_vs_seeded": True,
           "refresh_ms": refresh_ms, "refresh_upload_bytes": refresh_up,
           "refresh_split": refresh_split,
           "refresh_fetch_ms": [sp["fetch_ms"] for sp in refresh_split],
           "refresh_fetch_phases_ms": refresh_phases,
           "refresh_ingest_ms": ingest_ms,
           "refresh_scrapes": [k for k, _ in DASH_REFRESHES],
           "compactions": compactions, "appends": rt.appends,
           "served_vs_cold_max_abs_err": worst,
           "quantile_refresh_ms": quantile_ms,
           "quantile_served_vs_cold_max_abs_err": worst_q,
           "panels": panels, "evaluator": evaluator,
           "evaluator_refreshes": eval_refreshes,
           "evaluator_refresh_seconds": eval_s, "launches": launches}
    emit(res)
    return res, {"store": store, "engine": engine, "end": end,
                 "labels": built["labels"], "feed": built["feed"],
                 "http": built["http"],
                 "gids": gids, "group_keys": group_keys,
                 "replay": {"store": built["replay"],
                            "labels": built["labels"], "batches": batches,
                            "feed": copy.deepcopy(built["feed"]),
                            "cold": out, "served": served_all}}


class StandingQuery:
    """One subscribed dashboard panel as the fleet reads it (the
    reference's matstream, duck-typed): its query text, grid and tenant,
    and due() until its interval is served.  The fleet parses ``q``."""

    def __init__(self, q: str, step: int, duration: int):
        self.q, self.step, self.duration = q, step, duration
        self.tenant = TENANT
        self.end = None

    def due(self, now_ms: int) -> bool:
        return self.end is None or now_ms // self.step * self.step > self.end


class FleetAPI:
    """What FleetPlane.run reads of a serving front end: the storage, the
    engine (``tpu``), the standing queries and the evaluation context of a
    query (``_ec``: the lookback delta, series limit and engine, as the
    reference's PrometheusAPI._ec gives them)."""

    def __init__(self, storage, engine, streams):
        self.storage, self.tpu, self._streams = storage, engine, streams
        self.matstreams = self

    def streams(self):
        return list(self._streams)

    def _ec(self, start, end, step, tenant=TENANT) -> EvalConfig:
        return EvalConfig(start=start, end=end, step=step,
                          storage=self.storage,
                          lookback_delta=LOOKBACK_DELTA,
                          max_series=MAX_SERIES, tpu=self.tpu, tenant=tenant)


def group_key(labels) -> bytes:
    """The evaluator's group key of one group, ((label, value), ...): the
    marshalled name with only those labels (query/eval.py _group_key), which
    is what the evaluator emits a served group's row under."""
    return MetricName(b"", [(k.encode(), v.encode())
                            for k, v in labels]).marshal()


def served_by_take(plane, api, streams, now) -> dict:
    """Every due stream's text through exec_query(api._ec(...)) right after
    the interval's run: each must be a fleet.take hit (plane.served up by
    one a stream, no launch, no store fetch) whose rows are the plane's
    result table's, group key and values bit for bit (the groups that are
    NaN at every step dropped, as exec_query drops them)."""
    served0, before, ph0 = plane.served, dict(kernels.LAUNCHES), \
        fetch_phases()
    t0 = time.perf_counter()
    got = [exec_query(api._ec(now - st.duration, now, st.step, st.tenant),
                      st.q) for st, *_ in streams]
    wall = time.perf_counter() - t0
    launches = launched_since(before)
    if plane.served - served0 != len(streams) or launches or \
            fetch_phases() != ph0:
        raise AssertionError(
            f"fleet: {plane.served - served0} of {len(streams)} evaluations "
            f"served from the table; launches {launches}, fetch "
            f"{phases_ms(ph0, fetch_phases())}")
    for (st, sh, *_), rows in zip(streams, got):
        r = plane._results[sh["skey"]]
        want = sorted((k, row) for k, row in zip(r.group_keys, r.rows)
                      if not np.isnan(row).all())
        if [bytes(ts.metric_name.marshal()) for ts in rows] != \
                [k for k, _ in want]:
            raise AssertionError(f"fleet take {st.q}: other groups")
        assert_exact(f"fleet take {st.q}",
                     torch.from_numpy(np.stack([ts.values for ts in rows])),
                     torch.from_numpy(np.stack([row for _, row in want])))
    return {"evaluations": len(got), "exec_ms": wall * 1e3,
            "served": plane.served - served0}


def fleet_text(aggr: str, func: str, grouping, without: bool) -> str:
    """A standing query's text: aggr by|without (grouping)(func(m[5m]))."""
    return f"{aggr} {'without' if without else 'by'} " \
        f"({','.join(grouping)})({func}({SELECTOR}[5m]))"


def fleet_queries(funcs=FLEET_FUNCS) -> list[tuple]:
    """The fleet's standing queries: (text, step, duration, grid,
    grouping index, func, aggregate), `funcs` x the 8 aggregates x each
    grid's two groupings: 128 for FLEET_FUNCS, the phase's 64 for
    FLEET_STANDING_FUNCS."""
    out = []
    for grid, (dur, step, groupings) in FLEET_GRIDS.items():
        for func in funcs:
            for aggr in dr.FLEET_AGGR_CODES:
                for gi, (grouping, without) in enumerate(groupings):
                    out.append((fleet_text(aggr, func, grouping, without),
                                step, dur, grid, gi, func, aggr))
    return out


def standing_info(plane, api, st, func, aggr, grouping, without) -> dict:
    """The fleet's own analysis of a standing query's text, which must
    name the shape the text was written for on the resident selector's
    window: otherwise the fleet would adopt nothing, so the phase fails
    here."""
    info = plane._analyze(api, st)
    want, _ = ce.device_roll_keys(SELECTOR, TENANT, func, aggr, None,
                                  grouping, without, MAX_SERIES, WINDOW)
    if info is None or info["skey"] != want or info["window"] != WINDOW:
        raise AssertionError(
            f"fleet: the fleet reads {st.q!r} as "
            f"{None if info is None else info['skey']}, not {want}")
    return info


FLEET_SPLIT = {
    "h2d": SPLIT["h2d"], "d2h": SPLIT["d2h"],
    "append": 'vm_tpu_kernel_duration_seconds_sum{kernel="fleet_append_tile"',
    "compact":
        'vm_tpu_kernel_duration_seconds_sum{kernel="fleet_compact_tile"',
    "launch": 'vm_tpu_kernel_duration_seconds_sum'
              '{kernel="fleet_rollup_aggregate_tile"',
}


def _fleet_bound_b9(b) -> dict:
    """B9's least time on bucket `b` (timing.fleet_bound)."""
    return fleet_bound(int(b.counts_h.sum()), b.B_pad, b.S_b, b.G_b, b.T_b)


def _b9_args(b, now, dev) -> tuple:
    """B9's arguments for bucket `b` at the grid ending `now`."""
    shift = np.zeros(b.B_pad, np.int32)
    min_ts = np.zeros(b.B_pad, np.int32)
    for m in b.members:
        shift[m.slot] = now - m.duration - m.base_ms
        min_ts[m.slot] = -(m.lookback + m.lookback_delta)
    d = b.dev
    return (b.func, b.cfg, d["layout"], d["ts"], d["vals"], d["counts"],
            d["aggr"], torch.from_numpy(shift).to(dev),
            torch.from_numpy(min_ts).to(dev), d["v0"])


def fleet_events(plane, buckets, now, next_cutoff) -> dict:
    """B9, B10 and B11 on real buckets, CUDA-event timed beside their plain
    versions and each held against it: B9 on the grid-A buckets of rate by
    instance and of rate with no grouping (this interval's grid), B10 a
    steady interval's columns and B11 the resume's slide on the grid-B
    bucket of rate by instance."""
    out = {}
    a, one, bb = buckets
    dev = plane.engine.device
    args = _b9_args(a, now, dev)
    got, want = dr.fleet_rollup_aggregate_tile(*args), \
        dr.fleet_rollup_aggregate_tile_plain(*args)
    err = 0.0
    for m in a.members:
        e = aggr_close(f"B9 bucket A {m.aggr}", m.aggr, got[m.slot],
                       want[m.slot], a.func)
        if m.aggr not in ("stddev", "stdvar"):
            err = max(err, e)
    args1 = _b9_args(one, now, dev)
    out["fleet_rollup_aggregate_tile"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile(*args), reps=5),
        plain_ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile_plain(
            *args), reps=3), library_ms=None,
        shape=[a.B_pad, a.S_b, a.N_b, a.G_b, a.T_b],
        ms_one_group=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile(*args1),
                             reps=5),
        bound_ms_one_group=_fleet_bound_b9(one)["bound_ms"],
        # ms, device_ms and host_ms of both buckets, and the one-group
        # bucket's chunks per group (FLEET_CHUNK members each)
        by_instance=three_ms(lambda: dr.fleet_rollup_aggregate_tile(*args),
                             n=10, reps=5),
        one_group=three_ms(lambda: dr.fleet_rollup_aggregate_tile(*args1),
                           n=10, reps=5),
        chunks_one_group=dr.fleet_chunks(args1[2]),
        shape_one_group=[one.B_pad, one.S_b, one.N_b, one.G_b, one.T_b],
        **_fleet_bound_b9(a))
    # B10 on scratch copies of bucket B's planes, restored before each call
    d = bb.dev
    B, S, N = bb.B_pad, bb.S_b, bb.N_b
    K = 8
    cnt = d["counts"]
    new_ts = (d["ts"].gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
              SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
    new_vals = torch.rand((B, S, K), dtype=torch.float64, device=dev,
                          generator=torch.Generator(dev).manual_seed(4))
    new_counts = torch.zeros((B, S), dtype=torch.int32, device=dev)
    new_counts[:len(bb.members)] = 4  # a steady interval's 4 scrapes
    bufs = [torch.empty_like(t) for t in (d["ts"], d["vals"], cnt)]

    def fresh():
        for buf, t in zip(bufs, (d["ts"], d["vals"], cnt)):
            buf.copy_(t)

    fresh()
    got = [t.clone() for t in dr.fleet_append_tile(*bufs, new_ts, new_vals,
                                                   new_counts)]
    fresh()
    want = dr.fleet_append_tile_plain(*bufs, new_ts, new_vals, new_counts)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B10 bucket B {what}", g, w)
    n_new = int(new_counts.sum())
    out["fleet_append_tile"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: dr.fleet_append_tile(
            *bufs, new_ts, new_vals, new_counts), setup=fresh),
        plain_ms=cuda_ms(lambda: dr.fleet_append_tile_plain(
            *bufs, new_ts, new_vals, new_counts), setup=fresh, reps=3),
        library_ms=None, shape=[B, S, N, K],
        **bound(n_new * 12 * 2 + B * S * 12, n_new))
    del got, want, bufs
    # B11 at the cutoffs the resume will slide bucket B's members to
    cut = torch.zeros(B, dtype=torch.int32)
    for m in bb.members:
        cut[m.slot] = next_cutoff(m) - m.base_ms
    cut = cut.to(dev)
    got = dr.fleet_compact_tile(d["ts"], d["vals"], cnt, cut, cut)
    want = dr.fleet_compact_tile_plain(d["ts"], d["vals"], cnt, cut, cut)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B11 bucket B {what}", g, w)
    survivors = int(got[2].sum())
    dropped = int(cnt.sum()) - survivors
    del got, want
    out["fleet_compact_tile"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: dr.fleet_compact_tile(
            d["ts"], d["vals"], cnt, cut, cut)),
        plain_ms=cuda_ms(lambda: dr.fleet_compact_tile_plain(
            d["ts"], d["vals"], cnt, cut, cut), reps=3),
        library_ms=None, shape=[B, S, N],
        **bound(survivors * 12 + dropped * 4 + B * S * N * 12 + B * S * 8 +
                B * 8, B * S * N))
    return out


def phase_fleet(rng, dev, state) -> dict:
    """Fleet-batched serving on the dashboard's store and resident
    selector: 64 standing queries adopted into 8 buckets, six intervals
    through FleetPlane.run, each stream held against the per-stream path
    on the selector's own rolling tile (grid A's streams first: their fetch
    bound is the oldest, so the per-stream advance never slides the tile
    past it)."""
    store, engine = state["store"], state["engine"]
    print(json.dumps({"cut": {"fleet_standing_queries": len(
        fleet_queries(FLEET_STANDING_FUNCS)),
        "planned": len(fleet_queries()), "funcs": FLEET_STANDING_FUNCS,
        "planned_funcs": FLEET_FUNCS}}), flush=True)
    _, tkey = dashboard_keys()
    rt = engine.window_cache().get(tkey)
    S, G = DASH_SERIES, DASH_GROUPS
    inst, inst_keys = state["gids"], state["group_keys"]
    # by instance (or without id), and one group of every series, each
    # group under the evaluator's key for it
    layouts = ((inst, [group_key(k) for k in inst_keys],
                dr.group_layout(inst, G, dev)),
               (np.zeros(S, np.int32), [group_key(())],
                dr.group_layout(np.zeros(S, np.int32), 1, dev)))
    queries = [(StandingQuery(q, step, dur), *rest)
               for q, step, dur, *rest in
               fleet_queries(FLEET_STANDING_FUNCS)]
    api = FleetAPI(store, engine, [st for st, *_ in queries])
    plane = engine.fleet()
    now = -(-(state["end"] + FLEET_INTERVALS[0][1]) // 60_000) * 60_000
    # each stream's window filed under the key the fleet derives from its
    # text: the dashboard's own panel on grid A by the evaluator (a cold
    # exec_query, whose window the fleet must adopt), the others by
    # register_window on the resident selector's tile
    streams, parse_ms, evaluated = [], [], None
    for st, grid, gi, func, aggr in queries:
        gids, keys, groups = layouts[gi]
        t0 = time.perf_counter()
        info = standing_info(plane, api, st, func, aggr,
                             *FLEET_GRIDS[grid][2][gi])
        parse_ms.append((time.perf_counter() - t0) * 1e3)
        if st.q == PANEL_TEXTS["sum_by_instance"] and grid == "A":
            end0 = now - FLEET_INTERVALS[0][1]
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            rows = exec_query(api._ec(end0 - st.duration, end0, st.step),
                              st.q)
            stv = engine.window_cache().peek(info["skey"])
            if not rows or stv is None or len(stv) != 5 or stv[0] is rt or \
                    stv[3] is not None or stv[4] is None:
                raise AssertionError("fleet: the evaluator filed no window")
            eval_skey = info["skey"]
            evaluated = {"q": st.q, "exec_ms": (time.perf_counter() - t0) *
                         1e3, "launches": launched_since(before),
                         "skey": list(map(str, info["skey"]))}
        elif ce.register_window(engine, info["skey"], tkey, gids,
                                keys) is not rt:
            raise AssertionError("fleet: window not filed")
        streams.append((st, info, groups, grid))
    if evaluated is None:
        raise AssertionError("fleet: no stream filed through the evaluator")
    torch.cuda.reset_peak_memory_stats(dev)
    intervals, worst, events, takes = [], 0.0, None, []
    launches = dict.fromkeys(FLEET_KERNELS, 0)
    adoption_up = 0
    for i, (k, adv) in enumerate(FLEET_INTERVALS):
        if i:
            now += adv
        if i == len(FLEET_INTERVALS) - 1:
            # before the resume: B9-B11 timed on real buckets
            by = {(b.func, b.G_b, b.step): b
                  for b in plane._buckets.values()}
            one = fleet.bucket_up(1)  # the no-grouping buckets' groups
            events = fleet_events(
                plane, (by["rate", G, 60_000], by["rate", one, 60_000],
                        by["rate", G, SCRAPE]),
                now - adv,
                lambda m, t=now: t - m.duration - m.lookback -
                m.lookback_delta)
        ingest_s = ingest(store, state["labels"],
                          *state["feed"].next(k, now - adv))
        before = dict(kernels.LAUNCHES)
        up0 = tile_cache.bytes_uploaded()
        snap = {key: _metric_sum(n) for key, n in FLEET_SPLIT.items()}
        fetch0, ph0 = fetch_s(), fetch_phases()
        adopt0 = plane.adopt_s
        t0 = time.perf_counter()
        n = plane.run(api, now)
        wall = time.perf_counter() - t0
        up = tile_cache.bytes_uploaded() - up0
        split = {f"{key}_ms": (_metric_sum(m) - snap[key]) * 1e3
                 for key, m in FLEET_SPLIT.items()}
        fetched = phases_ms(ph0, fetch_phases())
        split["fetch_ms"] = (fetch_s() - fetch0) * 1e3
        # the rest: host staging, and in the adoption interval the
        # adoptions' host crops (adopt_ms holds each adoption's pull, whose
        # bytes d2h_ms counts, and its crop)
        split["stage_ms"] = wall * 1e3 - sum(split.values())
        split["adopt_ms"] = (plane.adopt_s - adopt0) * 1e3
        ran = {k2: kernels.LAUNCHES.get(k2, 0) - before.get(k2, 0)
               for k2 in FLEET_KERNELS}
        for k2 in FLEET_KERNELS:
            launches[k2] += ran[k2]
        stats = plane.stats()
        if n != stats["buckets"] or n != ran["fleet_rollup_aggregate_tile"] \
                or stats["members"] != len(streams) or stats["evictions"]:
            raise AssertionError(f"fleet interval {i}: {n} launches, "
                                 f"{ran}, {stats}, {plane.last_decline}")
        if i == 0:
            adoption_up = up
            if not plane.has(eval_skey):
                raise AssertionError("fleet: the evaluator's window was not "
                                     "adopted")
        takes.append(served_by_take(plane, api, streams, now))
        # the per-stream path: the selector's own rolling tile
        t0 = time.perf_counter()
        means = {}
        for st, sh, groups, grid in streams:
            start = now - st.duration
            fetch_lo = start - sh["window"] - LOOKBACK_DELTA
            if not ce.advance_rolling(engine, rt, store, FILTERS, start,
                                      fetch_lo, now, None, TENANT, True):
                raise AssertionError("fleet oracle declined: "
                                     + engine.last_roll_decline)
            cfg = RollupConfig(start, now, st.step, sh["window"])
            want = ce.run_fused_on_tiles(engine, sh["aggr"], sh["func"],
                                         rt.tiles, groups, cfg,
                                         start - rt.base_ms, fetch_lo - start)
            grouping = sh["skey"][6]
            if sh["aggr"] == "avg":
                means[grid, sh["func"], grouping] = want
            r = plane._results[sh["skey"]]
            if r.end != now or r.rows.shape != want.shape:
                raise AssertionError(f"fleet {st.q}: no result for {now}")
            # the group mean, for the variance's 16-ulp term (avg comes
            # before stddev and stdvar)
            mean = means.get((grid, sh["func"], grouping))
            e = aggr_close(f"fleet interval {i} {st.q}", sh["aggr"],
                           torch.from_numpy(r.rows), torch.from_numpy(want),
                           sh["func"],
                           None if mean is None else torch.from_numpy(mean))
            if sh["aggr"] not in ("stddev", "stdvar"):
                worst = max(worst, e)
            if not np.isfinite(r.rows).any():
                raise AssertionError(f"fleet {st.q}: no finite value")
            st.end = now
        oracle_s = time.perf_counter() - t0
        intervals.append({"scrapes": k, "ingest_ms": ingest_s * 1e3,
                          "fetch_phases_ms": fetched,
                          "fleet_ms": wall * 1e3,
                          "split": split, "upload_bytes": up,
                          "launches": ran, "per_stream_ms": oracle_s * 1e3,
                          "take": takes[-1]})
    steady = [iv["upload_bytes"] for iv in intervals[1:-1]]
    if max(steady) * 20 > adoption_up:
        raise AssertionError("fleet: steady intervals uploaded too much")
    if launches["fleet_compact_tile"] < 1:
        raise AssertionError("fleet: the resume slid no bucket (B11)")
    buckets = sorted(plane._buckets.values(), key=lambda b: b.key)
    res = {"phase": "fleet", "ok": True, "streams": len(streams),
           "parsed_streams": len(parse_ms),
           "analysis_ms": {"first": parse_ms[0],
                           "median": float(np.median(parse_ms)),
                           "max": max(parse_ms)},
           "buckets": [{"func": b.func, "step": b.step, "B": b.B_pad,
                        "S": b.S_b, "N": b.N_b, "T": b.T_b, "G": b.G_b}
                       for b in buckets],
           "device_plane_bytes": sum(b.ts_h.nbytes + b.vals_h.nbytes
                                     for b in buckets),
           "adoptions": plane.adoptions,
           "adopt_ms_per_stream": plane.adopt_s / plane.adoptions * 1e3,
           "adoption_upload_bytes": adoption_up, "intervals": intervals,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
           "fleet_vs_per_stream_max_abs_err": worst, "launches": launches,
           "evaluator_filed": evaluated,
           "take_exec_ms": [t["exec_ms"] for t in takes],
           "kernels": events}
    emit(res)
    engine._fleet = None  # the planes and mirrors go before full width
    return res



# ---------------------------------------------------------------------------
# The http phase: the port's vmsingle over localhost TCP.
# ---------------------------------------------------------------------------

#: seconds the cluster phase waits for vmselect's build, whose attach
#: (probe, engine, warm-up) it overlaps with the hour's writes
HTTP_ATTACH_S = 600
#: the standing queries of the http phase's fleet: rate by instance under
#: every aggregate, one bucket, a 30-minute window on the dashboard's step
HTTP_STREAM_DUR = 30 * 60_000
HTTP_FLEET_INTERVALS = 3
#: the series the watch check writes over the last 30 minutes of the
#: wall clock
WATCH_SERIES, WATCH_SELECTOR = 256, "watch_requests_total"


class HttpClient:
    """GET and POST against the server on localhost: (status, body, round
    trip ms); the last response's headers in ``headers``."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"
        self.headers = None

    def _do(self, req) -> tuple[int, bytes, float]:
        import urllib.error
        import urllib.request
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                body, code, self.headers = r.read(), r.status, r.headers
        except urllib.error.HTTPError as e:
            body, code, self.headers = e.read(), e.code, e.headers
        return code, body, (time.perf_counter() - t0) * 1e3

    def url(self, path: str, **params) -> str:
        import urllib.parse
        return self.base + path + ("?" + urllib.parse.urlencode(params)
                                   if params else "")

    def get(self, path: str, headers=None, **params
            ) -> tuple[int, bytes, float]:
        import urllib.request
        return self._do(urllib.request.Request(self.url(path, **params),
                                               headers=headers or {}))

    def post(self, path: str, body: bytes, headers=None
             ) -> tuple[int, bytes, float]:
        import urllib.request
        return self._do(urllib.request.Request(
            self.url(path), data=body, method="POST", headers=headers or {}))

    def json(self, path: str, **params) -> tuple[dict, float]:
        """A 200 GET's JSON body and round trip ms; the body's size and
        its parse ms in ``last``."""
        code, body, ms = self.get(path, **params)
        if code != 200:
            raise AssertionError(f"http {path} {params}: {code} {body[:300]}")
        t0 = time.perf_counter()
        out = json.loads(body)
        self.last = {"body_bytes": len(body),
                     "parse_ms": (time.perf_counter() - t0) * 1e3}
        return out, ms

    def server_cost(self, q: str, start: int, end: int) -> dict:
        """The server's cost split (wall ms by phase) of its newest request
        for `q` over [start, end], from the slow-query log."""
        slow, _ = self.json("/api/v1/status/slow_queries")
        for rec in slow["data"]:
            if rec["query"] == q and rec["start"] == start and \
                    rec["end"] == end:
                return rec.get("cost", {}).get("wallMsByPhase", {})
        raise AssertionError(f"http: no slow-query record of {q!r}")


def served_result(rows, grid_s) -> dict:
    """exec_query rows serialised as h_query_range serialises them
    (query/format_value.fmt_value, NaN points and empty series dropped),
    keyed by the metric's labels."""
    from victoriametrics_tpu_torch.query.format_value import fmt_value
    out = {}
    for r in rows:
        vals = [[float(t), fmt_value(v)] for t, v in zip(grid_s, r.values)
                if not np.isnan(v)]
        if vals:
            out[json.dumps(r.metric_name.to_dict(), sort_keys=True)] = vals
    return out


def body_result(body: dict) -> dict:
    """A query_range (matrix) or query (vector) body's result, keyed as
    served_result keys it."""
    res = body["data"]["result"]
    return {json.dumps(e["metric"], sort_keys=True):
            e["values"] if "values" in e else [e["value"]] for e in res}


def same_strings(what: str, got: dict, want: dict) -> None:
    """Two keyed results: the same series, timestamps and value strings
    (fmt_value is repr: equal strings are equal bits)."""
    if got.keys() != want.keys() or not got:
        raise AssertionError(f"{what}: other series ({len(got)} vs "
                             f"{len(want)})")
    for k in got:
        if [[float(t), v] for t, v in got[k]] != \
                [[float(t), v] for t, v in want[k]]:
            raise AssertionError(f"{what}: {k} differs")


def keyed_close(what: str, got: dict, want: dict, rtol: float, atol: float,
                aggr: str | None = None) -> float:
    """Two keyed results at (rtol, atol) on their timestamps (or, for an
    aggregate, at aggr_close's bounds); the largest difference."""
    if got.keys() != want.keys() or not got:
        raise AssertionError(f"{what}: other series ({len(got)} vs "
                             f"{len(want)})")
    keys = sorted(got)
    stamps = sorted({float(t) for k in keys for t, _ in got[k] + want[k]})
    col = {t: i for i, t in enumerate(stamps)}

    def grid(res):
        a = np.full((len(keys), len(stamps)), np.nan)
        for i, k in enumerate(keys):
            for t, v in res[k]:
                a[i, col[float(t)]] = float(v)
        return torch.from_numpy(a)
    g, w = grid(got), grid(want)
    if aggr is not None:
        return aggr_close(what, aggr, g, w, "rate")
    return assert_close(what, g, w, rtol, atol)


def write_request(labels, ts, vals) -> bytes:
    """One remote-write body (snappy) of the (S, k) columns, built with the
    port's remote_write.build_write_request."""
    from victoriametrics_tpu_torch.ingest import remote_write
    return remote_write.build_write_request(
        [(sorted(lb.items()), list(zip(t.tolist(), v.tolist())))
         for lb, t, v in zip(labels, ts, vals)])


def metric_sums(text: str, names) -> dict[str, float]:
    """The sum of every /metrics sample line starting with each name."""
    out = dict.fromkeys(names, 0.0)
    for line in text.splitlines():
        for n in names:
            if line.startswith(n):
                out[n] += float(line.rsplit(" ", 1)[1])
    return out


#: /metrics families the phase's device work must move
HTTP_DEVICE_METRICS = (
    'vm_tpu_kernel_duration_seconds_count{kernel="decode_tiles"',
    'vm_tpu_kernel_duration_seconds_count{kernel="rollup_aggregate_tile"',
    'vm_tpu_kernel_duration_seconds_count{kernel="append_tile"',
    'vm_tpu_kernel_duration_seconds_count'
    '{kernel="fleet_rollup_aggregate_tile"',
    "vm_device_bytes_uploaded_total", "vm_device_bytes_downloaded_total")


def http_panels(c, api, grid, aside) -> tuple[dict, dict]:
    """The nine panels over GET /api/v1/query_range on the dashboard's
    grid, each: its route's kernels launched; its values, as strings, the
    port's exec_query on the same EvalConfig called in-process; within the
    evaluator check's bounds of the host evaluator; its round trip and the
    server's cost split (the slow-query log's record of the request)."""
    start, end = grid
    step_s = DASH_STEP / 1e3
    grid_s = np.arange(start, end + 1, DASH_STEP) / 1e3
    out, served = {}, {}
    for panel, q in PANEL_TEXTS.items():
        before, f0 = dict(kernels.LAUNCHES), fetch_s()
        body, ms = c.json("/api/v1/query_range", query=q, start=start / 1e3,
                          end=end / 1e3, step=step_s)
        fetch_ms = (fetch_s() - f0) * 1e3
        launches = launched_since(before)
        want = ORACLE_KERNELS[panel]
        if not all(launches.get(k) for k in want) or (
                panel != "sum_by_instance" and launches.get("decode_tiles")):
            raise AssertionError(f"http {q!r} launched {launches}, not its "
                                 f"route's {want}")
        got = served[panel] = body_result(body)
        with aside():
            t0 = time.perf_counter()
            direct = exec_query(api._ec(start, end, DASH_STEP), q)
            direct_ms = (time.perf_counter() - t0) * 1e3
        same_strings(f"http {q!r} vs exec_query", got,
                     served_result(direct, grid_s))
        ec = api._ec(start, end, DASH_STEP)
        ec.tpu, ec.disable_cache = None, True
        host = served_result(exec_query(ec, q), grid_s)
        tol = QUANTILE_TOL if panel in ("quantile_by_instance", "median") \
            else (1e-12, 0.0)
        err = keyed_close(f"http {q!r} vs the host evaluator", got, host,
                          *tol)
        out[panel] = {"route": PANEL_ROUTES[panel], "round_trip_ms": ms,
                      **c.last, "fetch_ms": fetch_ms, "launches": launches,
                      "direct_exec_ms": direct_ms, "series": len(got),
                      "max_abs_err_vs_host": err, "rtol": tol[0],
                      "atol": tol[1], "cost": c.server_cost(q, start, end)}
    return out, served


def http_refreshes(c, api, st, grid, aside) -> list:
    """Two refreshes through the write API: one scrape of every series
    posted to /api/v1/write (remote write, snappy; the server's native
    columnar branch, which must hold every series' key), then the sum
    panel on
    the grid advanced one step, which the resident window serves (K3, no
    K1); held at rtol 1e-12 against nocache=1 over HTTP and against the
    host evaluator."""
    from victoriametrics_tpu_torch.ingest import snappy
    start, end = grid
    q = PANEL_TEXTS["sum_by_instance"]
    out = []
    for _ in range(2):
        ts, vals = st["feed"].next(1, end)
        t0 = time.perf_counter()
        body = write_request(st["labels"], ts, vals)
        build_ms = (time.perf_counter() - t0) * 1e3
        code, resp, write_ms = c.post("/api/v1/write", body,
                                      {"Content-Encoding": "snappy"})
        if code != 204:
            raise AssertionError(f"http remote write: {code} {resp[:300]}")
        if columnar_keys(api.storage) != len(st["labels"]) or \
                api.columnar_drop_stats:
            raise AssertionError("http remote write: not the columnar "
                                 "branch, or rows dropped")
        start, end = start + DASH_STEP, end + DASH_STEP
        kw = dict(query=q, start=start / 1e3, end=end / 1e3,
                  step=DASH_STEP / 1e3)
        before = dict(kernels.LAUNCHES)
        got, ms = c.json("/api/v1/query_range", **kw)
        launches = launched_since(before)
        if not launches.get("append_tile") or launches.get("decode_tiles"):
            raise AssertionError(f"http refresh launched {launches}, not "
                                 f"the resident window's K3")
        cost = c.server_cost(q, start, end)
        with aside():
            nocache, nocache_ms = c.json("/api/v1/query_range", nocache="1",
                                         **kw)
        ec = api._ec(start, end, DASH_STEP)
        ec.tpu, ec.disable_cache = None, True
        grid_s = np.arange(start, end + 1, DASH_STEP) / 1e3
        got = body_result(got)
        out.append({
            "rows": int(ts.size), "write_body_bytes": len(body),
            "write_build_ms": build_ms, "write_ms": write_ms,
            "write_rows_per_s": ts.size / write_ms * 1e3,
            "snappy_codec": "libsnappy" if snappy._lib is not None
            else "pure-python",
            "server_route": "add_rows_columnar",
            "columnar_keys": columnar_keys(api.storage),
            "round_trip_ms": ms, "launches": launches, "cost": cost,
            "nocache_round_trip_ms": nocache_ms,
            "vs_nocache_max_abs_err": keyed_close(
                "http refresh vs nocache", got, body_result(nocache),
                1e-12, 0.0),
            "vs_host_max_abs_err": keyed_close(
                "http refresh vs the host evaluator", got,
                served_result(exec_query(ec, q), grid_s), 1e-12, 0.0)})
    return out, (start, end)


def http_instants(c, api, t_ms: int, aside) -> dict:
    """Two instant queries over GET /api/v1/query: quantile(0.9) by
    instance (B5 + B8) and topk(10) (B5 + B6 + take_rows), each held as a
    panel is."""
    out = {}
    for name, q, kinds, tol in (
            ("quantile", PANEL_TEXTS["quantile_by_instance"],
             ("rollup_tile", "rollup_quantile_tile"), QUANTILE_TOL),
            ("topk", PANEL_TEXTS["topk"],
             ("rollup_tile", "topk_select_tile", "take_rows"),
             (1e-12, 0.0))):
        before = dict(kernels.LAUNCHES)
        body, ms = c.json("/api/v1/query", query=q, time=t_ms / 1e3)
        launches = launched_since(before)
        if not all(launches.get(k) for k in kinds):
            raise AssertionError(f"http instant {q!r} launched {launches}")
        got = body_result(body)
        step = 300_000  # h_query's default step
        with aside():
            direct = exec_query(api._ec(t_ms, t_ms, step), q)
        same_strings(f"http instant {q!r} vs exec_query", got,
                     served_result(direct, [t_ms / 1e3]))
        ec = api._ec(t_ms, t_ms, step)
        ec.tpu, ec.disable_cache = None, True
        out[name] = {"round_trip_ms": ms, "launches": launches,
                     "cost": c.server_cost(q, t_ms, t_ms),
                     "series": len(got),
                     "max_abs_err_vs_host": keyed_close(
                         f"http instant {q!r} vs the host evaluator", got,
                         served_result(exec_query(ec, q), [t_ms / 1e3]),
                         *tol)}
    return out


def http_fleet(c, api, st, end: int, aside) -> dict:
    """Eight standing queries (rate by instance under the 8 aggregates, one
    bucket) subscribed through the server's registry, pumped with
    next_frame pinned to the data's clock for three intervals whose
    scrapes go through /api/v1/write: from the second interval on exactly
    one B9 launch per bucket, B10 appends and every stream served; each
    stream's frames, reassembled, equal its polled query_range over HTTP
    at rtol 1e-12; after the last interval each stream within the fleet
    phase's bounds of the host evaluator."""
    from victoriametrics_tpu_torch.query.matstream import StreamClient
    texts = [fleet_text(aggr, "rate", ("instance",), False)
             for aggr in dr.FLEET_AGGR_CODES]
    end = end // DASH_STEP * DASH_STEP
    subs = [api.matstreams.subscribe(q, DASH_STEP, HTTP_STREAM_DUR)
            for q in texts]
    clis = [StreamClient() for _ in texts]
    try:
        t0 = time.perf_counter()
        for sub, cli in zip(subs, clis):
            f = sub.next_frame(timeout_s=120, now_ms=end)
            if f is None or f["type"] != "snapshot":
                raise AssertionError(f"http fleet: first frame {f}")
            cli.apply(f)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        plane = api.tpu.fleet()
        intervals = []
        for i in range(HTTP_FLEET_INTERVALS):
            ts, vals = st["feed"].next(4, end)
            code, _, write_ms = c.post(
                "/api/v1/write", write_request(st["labels"], ts, vals),
                {"Content-Encoding": "snappy"})
            if code != 204:
                raise AssertionError(f"http fleet write: {code}")
            end += DASH_STEP
            st0, before = plane.stats(), dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            for sub, cli in zip(subs, clis):
                f = sub.next_frame(timeout_s=120, now_ms=end)
                if f is None:
                    raise AssertionError("http fleet: a stream did not "
                                         "advance")
                cli.apply(f)
            wall = (time.perf_counter() - t0) * 1e3
            launches, st1 = launched_since(before), plane.stats()
            buckets = st1["buckets"]
            if i >= 1 and (
                    buckets != 1 or st1["members"] != len(texts) or
                    launches.get("fleet_rollup_aggregate_tile") != buckets or
                    st1["launches"] - st0["launches"] != buckets or
                    not launches.get("fleet_append_tile") or
                    st1["served"] - st0["served"] != len(texts)):
                raise AssertionError(f"http fleet interval {i}: {launches}, "
                                     f"{st0} -> {st1}")
            polled = 0.0
            for q, cli in zip(texts, clis):
                body, ms = c.json("/api/v1/query_range", query=q,
                                  start=(end - HTTP_STREAM_DUR) / 1e3,
                                  end=end / 1e3, step=DASH_STEP / 1e3)
                polled += ms
                pushed = {json.dumps(e["metric"], sort_keys=True):
                          e["values"] for e in cli.result()}
                keyed_close(f"http fleet {q!r} pushed vs polled", pushed,
                            body_result(body), 1e-12, 0.0)
            intervals.append({"write_ms": write_ms,
                              "write_rows_per_s": ts.size / write_ms * 1e3,
                              "interval_ms": wall, "launches": launches,
                              "stats": st1, "polls_ms": polled})
        # rate is a counter func: aggr_close needs no group mean for it
        worst = {}
        grid_s = np.arange(end - HTTP_STREAM_DUR, end + 1, DASH_STEP) / 1e3
        for q, aggr, cli in zip(texts, dr.FLEET_AGGR_CODES, clis):
            ec = api._ec(end - HTTP_STREAM_DUR, end, DASH_STEP)
            ec.tpu, ec.disable_cache = None, True
            host = served_result(exec_query(ec, q), grid_s)
            pushed = {json.dumps(e["metric"], sort_keys=True): e["values"]
                      for e in cli.result()}
            worst[aggr] = keyed_close(f"http fleet {q!r} vs the host "
                                      f"evaluator", pushed, host, 1e-12, 0.0,
                                      aggr=aggr)
    finally:
        for sub in subs:
            sub.close()
    return {"streams": len(texts), "window_ms": HTTP_STREAM_DUR,
            "data_end_ms": end,
            "snapshot_ms": snapshot_ms, "intervals": intervals,
            "vs_host_max_abs_err": worst,
            "adoptions": plane.adoptions}


def http_watch(c) -> dict:
    """256 series over the last 30 minutes of the wall clock through POST
    /api/v1/import (JSON lines), then /api/v1/watch with max_frames=1: its
    SSE snapshot frame, reassembled, equals the polled query_range of the
    same window."""
    import urllib.request
    from victoriametrics_tpu_torch.query.matstream import StreamClient
    rng = np.random.default_rng(11)
    now = int(time.time() * 1000)
    n = 30 * 60_000 // SCRAPE
    lines = []
    for i in range(WATCH_SERIES):
        ts = now - 30 * 60_000 + np.arange(n) * SCRAPE + \
            int(rng.integers(0, SCRAPE))
        vals = np.cumsum(rng.integers(0, 50, n)).astype(float)
        lines.append(json.dumps({
            "metric": {"__name__": WATCH_SELECTOR,
                       "instance": f"host-{i % 16}", "id": str(i)},
            "values": vals.tolist(), "timestamps": ts.tolist()}))
    code, _, import_ms = c.post("/api/v1/import", "\n".join(lines).encode())
    if code != 204:
        raise AssertionError(f"http import: {code}")
    q = f"sum(rate({WATCH_SELECTOR}[5m]))"
    cli, frames = StreamClient(), []
    t0 = time.perf_counter()
    with urllib.request.urlopen(c.url("/api/v1/watch", query=q, step="15s",
                                      range="15m", max_frames="1"),
                                timeout=300) as r:
        if r.headers["Content-Type"] != "text/event-stream":
            raise AssertionError("http watch: not an SSE stream")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                frames.append(json.loads(line[len("data: "):]))
                cli.apply(frames[-1])
    watch_ms = (time.perf_counter() - t0) * 1e3
    if len(frames) != 1 or frames[0]["type"] != "snapshot":
        raise AssertionError(f"http watch: frames {frames[:1]}")
    start_ms, end_ms, step_ms = cli.window
    body, poll_ms = c.json("/api/v1/query_range", query=q,
                           start=start_ms / 1e3, end=end_ms / 1e3,
                           step=step_ms / 1e3)
    pushed = {json.dumps(e["metric"], sort_keys=True): e["values"]
              for e in cli.result()}
    err = keyed_close("http watch snapshot vs poll", pushed,
                      body_result(body), 1e-12, 0.0)
    return {"series": WATCH_SERIES, "rows": WATCH_SERIES * n,
            "import_ms": import_ms,
            "import_rows_per_s": WATCH_SERIES * n / import_ms * 1e3,
            "watch_ms": watch_ms, "poll_ms": poll_ms,
            "steps": (end_ms - start_ms) // step_ms + 1,
            "max_abs_err_vs_poll": err}


def phase_http(dev, st, dash) -> dict:
    """The port's vmsingle on a copy of the dashboard's store, started as
    a user starts it (apps.vmsingle build(parse_flags(...)) with no
    backend flag) and driven over localhost TCP: the default attach must
    give the server the CUDA engine; the nine panels, the repeat, two
    refreshes through the write API, two instant queries, eight standing
    queries through the server's registry and an SSE watch; then
    /metrics and /api/v1/status/top_queries.  Its launch counts leave out
    the in-process comparisons."""
    from victoriametrics_tpu_torch.apps import vmsingle
    from victoriametrics_tpu_torch.utils import profiler
    t_phase = time.perf_counter()
    aside = Aside()
    rrc.GLOBAL.reset()
    slow0 = os.environ.get("VM_SLOW_QUERY_MS")
    # every request lands in the slow-query log with its cost split
    os.environ["VM_SLOW_QUERY_MS"] = "0.001"
    t0 = time.perf_counter()
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={st['path']}", "-httpListenAddr=127.0.0.1:0"]))
    attach_s = time.perf_counter() - t0
    srv.start()
    try:
        probe = api.probe_result
        if api.tpu is None:
            raise AssertionError("http: the default backend attached no "
                                 "engine")
        attach = {**api.attach_timing, "attach_s": attach_s,
                  "probe_platform": probe.platform, "probe_devices": probe.n,
                  "probe_name": probe.name}
        c = HttpClient(srv.port)
        text0 = c.get("/metrics")[1].decode()
        kernels.reset_launches()
        start, end = dashboard_grid()
        start -= start % DASH_STEP
        end = start + -(-(end - start) // DASH_STEP) * DASH_STEP
        panels, served = http_panels(c, api, (start, end), aside)
        # the repeat: the sum's resident window answers with its warm path
        # (one K2, no K1, no fetch); topk, whose result the rollup result
        # cache holds, is a full hit of it (no launch, no fetch)
        repeat = {}
        for panel in ("sum_by_instance", "topk"):
            before, ph0 = dict(kernels.LAUNCHES), fetch_phases()
            body, ms = c.json("/api/v1/query_range", query=PANEL_TEXTS[panel],
                              start=start / 1e3, end=end / 1e3,
                              step=DASH_STEP / 1e3)
            launches = launched_since(before)
            allowed = {"rollup_aggregate_tile": 1} \
                if panel == "sum_by_instance" else {}
            if launches not in ({}, allowed) or fetch_phases() != ph0:
                raise AssertionError(f"http repeat {panel}: {launches}, "
                                     f"fetch {phases_ms(ph0, fetch_phases())}")
            same_strings(f"http repeat {panel}", body_result(body),
                         served[panel])
            repeat[panel] = {"round_trip_ms": ms, "launches": launches,
                             "fetch_phases_unchanged": True}
        refreshes, (start, end) = http_refreshes(c, api, st, (start, end),
                                                 aside)
        instants = http_instants(c, api, end, aside)
        fl = http_fleet(c, api, st, end, aside)
        # the satellites phase's data: SAT_PREROLL more minutes, so that
        # the 5-minute windows of its instants (and the sample before
        # each) hold neither the refreshes' one-scrape minutes nor the
        # jump where this copy's feed resumes after the dashboard's
        # refreshes; its alert threshold at the first instant
        st["end"] = fl["data_end_ms"]
        for _ in range(SAT_PREROLL):
            sat_scrape(c, st, st["end"])
            st["end"] += DASH_STEP
        st["threshold"] = sat_threshold(api.storage, st["end"])
        watch = http_watch(c)
        text1 = c.get("/metrics")[1].decode()
        m0, m1 = (metric_sums(t, HTTP_DEVICE_METRICS) for t in (text0, text1))
        unmoved = [n for n in HTTP_DEVICE_METRICS if not m1[n] > m0[n]]
        if unmoved:
            raise AssertionError(f"http /metrics: {unmoved} did not move")
        tops, _ = c.json("/api/v1/status/top_queries", topN="100")
        listed = {r["query"] for r in tops["topByCount"]}
        if not set(PANEL_TEXTS.values()) <= listed:
            raise AssertionError("http top_queries: panels missing")
        launches = {k: kernels.LAUNCHES.get(k, 0) - aside.n.get(k, 0)
                    for k in SOURCES}
    finally:
        srv.stop()
        storage.close()
        profiler.PROFILER.stop()
        if slow0 is None:
            os.environ.pop("VM_SLOW_QUERY_MS", None)
        else:
            os.environ["VM_SLOW_QUERY_MS"] = slow0
    res = {"phase": "http", "ok": True, "attach": attach,
           "panels": panels,
           "evaluator_exec_ms": {p: dash["evaluator"]["panels"][p]["exec_ms"]
                                 for p in PANEL_TEXTS},
           "repeat": repeat, "refreshes": refreshes, "instants": instants,
           "fleet": fl, "watch": watch,
           "metrics_moved": {n: m1[n] - m0[n] for n in HTTP_DEVICE_METRICS},
           "wall_s": time.perf_counter() - t_phase, "launches": launches}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The satellites phase: rules, vmalert, vmagent and Graphite on vmsingle.
# ---------------------------------------------------------------------------

#: the seeded columns the Graphite check keeps of the dashboard's history
#: (the last hour and more: 260 scrapes)
SAT_TAIL = 260
#: the scrape minutes the http phase writes ahead of the satellites
#: phase's first instant
SAT_PREROLL = 3
#: the rule group: the bench headline recorded twice (the two share one
#: evaluation an instant) and an alert on it; the group's own loop is
#: stopped and the group evaluated on the data's clock
SAT_EXPR = PANEL_TEXTS["sum_by_instance"]
SAT_ALERT = "RequestRateHigh"
SAT_INSTANCE = "host-7"
SAT_RENDERS = {
    "sum_one_instance": f"sumSeries(seriesByTag('name={SELECTOR}',"
                        f"'instance={SAT_INSTANCE}'))",
    "group_by_instance": f"groupByTags(seriesByTag('name={SELECTOR}'),"
                         "'sum','instance')",
    "per_second_one_instance": f"perSecond(seriesByTag('name={SELECTOR}',"
                               f"'instance={SAT_INSTANCE}'))",
}
#: the vmagent target's metric (vmagent sets job and instance itself, so
#: the served series keep their instance in `src`)
AGENT_METRIC = "agent_requests_total"


def sat_rules(threshold: float) -> dict:
    return {"groups": [{"name": "satellites", "interval": "1h", "rules": [
        {"record": "instance:m:rate5m", "expr": SAT_EXPR},
        {"record": "instance:m:rate5m:again", "expr": SAT_EXPR},
        {"alert": SAT_ALERT, "expr": f"{SAT_EXPR} > {threshold}",
         "for": "1m", "labels": {"severity": "page"}}]}]}


def sat_scrape(c, st, after: int) -> None:
    """One scrape of every series through /api/v1/write, a minute after
    `after`'s: the counters' increase over a minute (four 15 s
    increments), so that their rates hold at one scrape a minute."""
    ts, vals = st["feed"].next(4, after)
    ts, vals = ts[:, -1:], vals[:, -1:]
    st["feed"].history[-1] = (ts, vals)
    code, resp, _ = c.post("/api/v1/write", write_request(
        st["labels"], ts, vals), {"Content-Encoding": "snappy"})
    if code != 204:
        raise AssertionError(f"satellites write: {code} {resp[:300]}")


def sat_threshold(storage, t_ms: int) -> float:
    """The median instance's SAT_EXPR at t_ms on the host evaluator, so
    that about half the instances cross it at the first instant."""
    rows = exec_query(EvalConfig(
        start=t_ms, end=t_ms, step=WINDOW, storage=storage,
        lookback_delta=LOOKBACK_DELTA, max_series=MAX_SERIES,
        disable_cache=True), SAT_EXPR)
    return round(float(np.median([r.values[-1] for r in rows])), 3)


def rows_key(labels: dict) -> str:
    return json.dumps({k: v for k, v in labels.items() if k != "__name__"},
                      sort_keys=True)


def sat_rules_server(c, api, st, instants) -> dict:
    """(a) the server-side group: three instants, a scrape through
    /api/v1/write before the second and the third; each evaluation's
    launches, the rows against the host evaluator, the alert's states,
    the read-back and /api/v1/rules."""
    from victoriametrics_tpu_torch.query.format_value import fmt_value
    (g,) = api.rule_groups
    ms = api.matstreams
    calls, written = [], []
    real_query, real_write = g.ds.query, g.rw.write

    def query(expr, ts=None):
        before, e0 = dict(kernels.LAUNCHES), ms.instant_evals
        t0 = time.perf_counter()
        out = real_query(expr, ts)
        calls.append({"expr": expr, "ms": (time.perf_counter() - t0) * 1e3,
                      "evaluated": ms.instant_evals - e0,
                      "launches": launched_since(before)})
        return out
    g.ds.query = query
    g.rw.write = lambda rows: written.append(rows) or real_write(rows)
    states, evals = [], []
    try:
        for k, t in enumerate(instants):
            if k:
                sat_scrape(c, st, instants[k - 1])
            e0, r0, n0 = ms.instant_evals, ms.instant_reuse, len(calls)
            t0 = time.perf_counter()
            g.eval_once(t / 1e3, notify=False)
            wall = (time.perf_counter() - t0) * 1e3
            mine = calls[n0:]
            if (ms.instant_evals - e0, ms.instant_reuse - r0) != (2, 1) or \
                    [x["evaluated"] for x in mine] != [1, 0, 1]:
                raise AssertionError(
                    f"satellites instant {k}: {ms.instant_evals - e0} "
                    f"evaluations, {ms.instant_reuse - r0} reused, {mine}")
            for x in mine:
                if x["evaluated"] and not x["launches"].get(
                        "rollup_aggregate_tile"):
                    raise AssertionError(f"satellites instant {k}: "
                                         f"{x['expr']!r} launched "
                                         f"{x['launches']}, no K2")
                if not x["evaluated"] and x["launches"]:
                    raise AssertionError(f"satellites instant {k}: the "
                                         f"shared rule launched {x}")
            if k == 0 and not mine[0]["launches"].get("decode_tiles"):
                raise AssertionError(f"satellites cold instant: no K1 "
                                     f"({mine[0]['launches']})")
            states.append({s["labels"]["instance"]: s["state"]
                           for s in g.rules[2]._active.values()})
            evals.append({"instant_ms": t, "wall_ms": wall,
                          "routes": [{"evaluated": x["evaluated"],
                                      "launches": x["launches"],
                                      "ms": x["ms"]} for x in mine]})
    finally:
        g.ds.query, g.rw.write = real_query, real_write
    # the alert: inactive before the first instant, pending at it,
    # firing from the second for the instances still above
    counts = [collections.Counter(x.values()) for x in states]
    if set(counts[0]) != {"pending"} or not counts[1]["firing"] or \
            not counts[2]["firing"]:
        raise AssertionError(f"satellites alert states {counts}")
    # the rows recorded against the host evaluator's at each instant:
    # within the evaluator check's rtol 1e-12 for sums (K2 adds a group's
    # members in its own order, so the last bits may differ), and how
    # many are equal bit for bit; at the first instant, why (sat_sum_order)
    host_ms, worst, exact, order = [], 0.0, 0, None
    for t, rows in zip(instants, written):
        ec = api._ec(t, t, WINDOW)
        ec.tpu, ec.disable_cache = None, True
        t0 = time.perf_counter()
        host = {rows_key(r.metric_name.to_dict()):
                float(fmt_value(r.values[-1]))
                for r in exec_query(ec, SAT_EXPR)
                if not np.isnan(r.values[-1])}
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for name in ("instance:m:rate5m", "instance:m:rate5m:again"):
            rec = {rows_key(lb): v for lb, ts_, v in rows
                   if lb["__name__"] == name and ts_ == t}
            if order is None:
                order = sat_sum_order(api, t, host, rec)
            if sorted(rec) != sorted(host) or len(rec) != DASH_GROUPS:
                raise AssertionError(f"satellites {name} at {t}: "
                                     f"{len(rec)} rows, not the host's")
            got = np.array([rec[k] for k in sorted(host)])
            want = np.array([host[k] for k in sorted(host)])
            worst = max(worst, assert_close(f"satellites {name} at {t}",
                                            got, want, 1e-12, 0.0))
            exact += int(np.count_nonzero(got == want))
    t_last = instants[-1]
    back, _ = c.json("/api/v1/query", query="instance:m:rate5m",
                     time=t_last / 1e3)
    alerts, _ = c.json("/api/v1/query", time=t_last / 1e3,
                       query=f'ALERTS{{alertname="{SAT_ALERT}",'
                             'alertstate="firing"}')
    for_state, _ = c.json("/api/v1/query", time=t_last / 1e3,
                          query=f'ALERTS_FOR_STATE{{alertname="{SAT_ALERT}"}}')
    rules, _ = c.json("/api/v1/rules")
    (grp,) = rules["data"]["groups"]
    # a series of an earlier instant is still inside the lookback
    firing = {i for x in states[1:] for i, v in x.items() if v == "firing"}
    active = {i for x in states for i in x}
    if len(back["data"]["result"]) != DASH_GROUPS or \
            {r["metric"]["instance"] for r in alerts["data"]["result"]} != \
            firing or {r["metric"]["instance"] for r in
                       for_state["data"]["result"]} != active or \
            grp["name"] != "satellites" or \
            [r["name"] for r in grp["rules"]] != [
                "instance:m:rate5m", "instance:m:rate5m:again", SAT_ALERT] \
            or grp["rules"][2]["state"] != "firing":
        raise AssertionError(
            f"satellites: read-back {len(back['data']['result'])}, ALERTS "
            f"{len(alerts['data']['result'])}, ALERTS_FOR_STATE "
            f"{len(for_state['data']['result'])} ({counts}), rules "
            f"{grp}")
    return {"instants": evals, "alert_states": [dict(x) for x in counts],
            "host_ms": host_ms, "rows_vs_host_max_abs_err": worst,
            "rows_bitwise_equal_host": exact,
            "rows_checked": 2 * DASH_GROUPS * len(instants),
            "sum_order": order,
            "read_back_series": len(back["data"]["result"]),
            "alerts_firing": len(alerts["data"]["result"]),
            "alerts_for_state": len(for_state["data"]["result"]),
            "rules_listed": len(grp["rules"]), "written": written}


def sat_sum_order(api, t: int, host: dict, card: dict) -> dict:
    """Why the card's rows part from the host's in their last bits, read
    at `t`: the host evaluator's per-series rate(...) rows summed per
    instance in their order (a) with numpy's pairwise sum, which the host
    evaluator's sum uses, and (b) one after another, as K2 adds a group's
    members; and SAT_EXPR through the engine's route on the host
    (CUDAEngine(device="cpu"): the same tiles, K1's and K2's plain
    versions, their calls counted here).  Counts the rows that are equal
    bit for bit; it checks nothing (the rows' check is the caller's)."""
    from victoriametrics_tpu_torch.query.format_value import fmt_value
    from victoriametrics_tpu_torch.query.metricsql.parser import parse
    ec = api._ec(t, t, WINDOW)
    ec.tpu, ec.disable_cache = None, True
    members = collections.defaultdict(list)
    for r in exec_query(ec, str(parse(SAT_EXPR).args[0])):
        members[rows_key({"instance": r.metric_name.to_dict()[
            "instance"]})].append(r.values[-1])
    pairwise = {k: float(fmt_value(np.nansum(np.array(v)[:, None],
                                             axis=0)[0]))
                for k, v in members.items()}
    in_turn = {}
    for k, v in members.items():
        acc = 0.0
        for x in v:
            acc += x
        in_turn[k] = float(fmt_value(acc))
    calls = collections.Counter()
    real = {(dd, "decode_tiles_plain"): dd.decode_tiles_plain,
            (dr, "rollup_aggregate_tile_plain"):
                dr.rollup_aggregate_tile_plain}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    for (mod, name), fn in real.items():
        setattr(mod, name, counted(name, fn))
    try:
        ec.tpu = ce.CUDAEngine(device="cpu")
        t0 = time.perf_counter()
        plain = {rows_key(r.metric_name.to_dict()):
                 float(fmt_value(r.values[-1]))
                 for r in exec_query(ec, SAT_EXPR)
                 if not np.isnan(r.values[-1])}
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)

    def same(a, b):
        return sum(a.get(k) == v for k, v in b.items())
    return {"instant_ms": t, "rows": len(host),
            "host_eq_pairwise": same(host, pairwise),
            "host_eq_in_turn": same(host, in_turn),
            "plain_route_eq_in_turn": same(plain, in_turn),
            "plain_route_eq_host": same(plain, host),
            "card_eq_in_turn": same(card, in_turn),
            "card_eq_plain_route": same(card, plain),
            "plain_route_calls": dict(calls), "plain_route_ms": ms}


def sat_vmalert(port: int, rules_path: str, instants, server) -> dict:
    """(b) the standalone vmalert: -datasource.url and -remoteWrite.url at
    the server, -notifier.url at an Alertmanager stub of this process;
    the same group at the same instants, its rows equal the server-side
    group's, the stub receiving the firing alerts."""
    from victoriametrics_tpu_torch.apps import vmalert
    from victoriametrics_tpu_torch.httpapi.server import HTTPServer, Response
    received = []

    def h(req):
        received.append(json.loads(req.body))
        return Response.json({})
    am = HTTPServer("127.0.0.1", 0)
    am.route("/api/v2/alerts", h)
    am.start()
    base = f"http://127.0.0.1:{port}"
    groups, srv = vmalert.build(vmalert.parse_flags([
        f"-rule={rules_path}", f"-datasource.url={base}",
        f"-notifier.url=http://127.0.0.1:{am.port}",
        f"-remoteWrite.url={base}", "-httpListenAddr=127.0.0.1:0"]))
    (g,) = groups
    written = []
    real_write = g.rw.write
    g.rw.write = lambda rows: written.append(rows) or real_write(rows)
    walls = []
    try:
        for t in instants:
            t0 = time.perf_counter()
            g.eval_once(t / 1e3)
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        srv.stop()
        am.stop()
    if len(written) != len(instants) or any(
            sorted(map(json.dumps, a)) != sorted(map(json.dumps, b))
            for a, b in zip(written, server)):
        raise AssertionError("satellites vmalert: its rows are not the "
                             "server-side group's")
    firing = [len(batch) for batch in received]
    want = [sum(1 for lb, _, v in rows if lb["__name__"] == "ALERTS" and
                lb["alertstate"] == "firing") for rows in server]
    if firing != [n for n in want if n] or not all(
            a["labels"]["alertname"] == SAT_ALERT and
            a["labels"]["severity"] == "page"
            for batch in received for a in batch):
        raise AssertionError(f"satellites notifier: {firing} vs {want}")
    return {"eval_ms": walls, "rows_vs_server": "equal",
            "notifications": firing}


def sat_vmagent(tmp: str, st, api, base: str, after: int) -> dict:
    """(c) vmagent: a Prometheus-text target of this process serves the
    next scrape of the 8192 series (as AGENT_METRIC); vmagent scrapes it
    twice and remote-writes through its persistent queue and a relay of
    this process to the server; the relay is stopped for the second
    scrape, whose block waits in the sender and arrives once the relay is
    back.  Every row arrives, equal by name and value."""
    import urllib.request
    from victoriametrics_tpu_torch.apps import vmagent
    from victoriametrics_tpu_torch.httpapi.server import HTTPServer, Response
    feed = copy.deepcopy(st["feed"])
    feed.history = None
    scrapes = [feed.next(1, after), feed.next(1, after + SCRAPE)]
    page = {}

    def exposition(ts, vals):
        return "".join(
            f'{AGENT_METRIC}{{src="{lb["instance"]}",id="{lb["id"]}"}} '
            f'{v!r} {t}\n' for lb, t, v in zip(st["labels"], ts[:, 0].tolist(),
                                               vals[:, 0].tolist()))
    target = HTTPServer("127.0.0.1", 0)
    target.route("/metrics", lambda req: Response.text(page["text"]))
    target.start()

    def relay_write(req):
        r = urllib.request.Request(base + "/api/v1/write", data=req.body,
                                   method="POST")
        with urllib.request.urlopen(r, timeout=120) as resp:
            return Response(resp.status, b"")
    relay = HTTPServer("127.0.0.1", 0)
    relay.route("/api/v1/write", relay_write)
    relay.start()
    relay_port = relay.port
    cfg = os.path.join(tmp, "scrape.json")
    with open(cfg, "w") as f:
        json.dump({"scrape_configs": [{
            "job_name": "satellites", "scrape_interval": "1h",
            "static_configs": [{"targets": [f"127.0.0.1:{target.port}"]}]}]},
            f)
    agent, asrv = vmagent.build(vmagent.parse_flags([
        f"-promscrape.config={cfg}",
        f"-remoteWrite.url=http://127.0.0.1:{relay_port}/api/v1/write",
        f"-remoteWrite.tmpDataPath={os.path.join(tmp, 'queue')}",
        "-httpListenAddr=127.0.0.1:0"]))
    (ctx,) = agent.rw_ctxs
    (scraper,) = agent.targets.values()
    puts = []
    real_put = ctx.queue.put
    ctx.queue.put = lambda block: puts.append(len(block)) or real_put(block)
    filters = [TagFilter(b"", AGENT_METRIC.encode())]

    def stored():
        return {sd.metric_name.to_dict()["id"]: (sd.timestamps, sd.values)
                for sd in api.storage.search_series(
                    filters, after - DAY, after + DAY, tenant=TENANT)}

    def wait(cond, what, limit=60.0):
        deadline = time.perf_counter() + limit
        while not cond():
            if time.perf_counter() > deadline:
                raise AssertionError(f"satellites vmagent: {what}")
            time.sleep(0.05)
    out = {}
    try:
        ctx.start()
        t0 = time.perf_counter()
        page["text"] = exposition(*scrapes[0])
        scraper._scrape_once()
        wait(lambda: ctx.sent_rows >= 1 and not ctx._pending and
             ctx.queue.pending == 0, "the first scrape was not sent")
        out["first_scrape_ms"] = (time.perf_counter() - t0) * 1e3
        # the remote goes away: the second scrape's block is queued and
        # its sends fail until the relay listens again on its port
        relay.stop()
        errors0, sent0, puts0 = ctx.send_errors, ctx.sent_rows, len(puts)
        page["text"] = exposition(*scrapes[1])
        scraper._scrape_once()
        wait(lambda: ctx.send_errors > errors0, "no send failed while the "
             "remote was down")
        if ctx.sent_rows != sent0 or len(puts) <= puts0:
            raise AssertionError("satellites vmagent: the block was not "
                                 "queued")
        out["queued_while_down"] = {"blocks": len(puts) - puts0,
                                    "bytes": sum(puts[puts0:]),
                                    "send_errors": ctx.send_errors - errors0}
        t0 = time.perf_counter()
        relay = HTTPServer("127.0.0.1", relay_port)
        relay.route("/api/v1/write", relay_write)
        relay.start()
        wait(lambda: ctx.sent_rows > sent0, "the queued block was not "
             "delivered")
        out["delivered_after_restart_ms"] = (time.perf_counter() - t0) * 1e3
        api.storage.force_flush()
        got = stored()
        for lb, t1, v1, t2, v2 in zip(st["labels"], *[
                a[:, 0] for sc in scrapes for a in sc]):
            ts_, vs_ = got.get(lb["id"], (np.zeros(0), np.zeros(0)))
            if ts_.tolist() != [t1, t2] or vs_.tolist() != [v1, v2]:
                raise AssertionError(f"satellites vmagent: series "
                                     f"{lb['id']}: {ts_}, {vs_}")
        if len(got) != len(st["labels"]):
            raise AssertionError(f"satellites vmagent: {len(got)} series")
        status = agent.target_status()
        out.update(rows=2 * len(got), series=len(got),
                   target_health=status[0]["health"],
                   blocks_sent=ctx.sent_rows, rows_vs_served="equal")
    finally:
        agent.stop()
        asrv.stop()
        relay.stop()
        target.stop()
    return out


def graphite_last_in_bucket(ts, vals, grid, step) -> np.ndarray:
    """The render's consolidation, in numpy on the written values: at each
    grid point the last sample at or before it, if newer than one step."""
    out = np.full((ts.shape[0], grid.size), np.nan)
    for i in range(ts.shape[0]):
        idx = np.searchsorted(ts[i], grid, side="right") - 1
        ok = idx >= 0
        j = np.clip(idx, 0, None)
        ok &= grid - ts[i][j] < step
        out[i, ok] = vals[i][j][ok]
    return out


def sat_graphite(c, st, api, t_last: int) -> dict:
    """(d) Graphite on vmsingle: the three SAT_RENDERS over the last hour
    at the default 60 s step against graphite_last_in_bucket on the
    seeded and fed values; /metrics/find and /tags; one plaintext line
    through -graphiteListenAddr rendered back."""
    step = 60_000
    frm, until = t_last - 3_600_000, t_last
    grid = np.arange(frm - frm % step, until + 1, step, dtype=np.int64)
    ts = np.concatenate([st["tail"][0]] + [t for t, _ in
                                           st["feed"].history], axis=1)
    vals = np.concatenate([st["tail"][1]] + [v for _, v in
                                             st["feed"].history], axis=1)
    want = graphite_last_in_bucket(ts, vals, grid, step)
    inst = np.array([lb["instance"] for lb in st["labels"]])
    ids = [lb["id"] for lb in st["labels"]]
    one = inst == SAT_INSTANCE
    with np.errstate(all="ignore"):
        d = np.diff(want[one], prepend=np.nan, axis=1)
        per_second = np.where(d >= 0, d / (step / 1e3), np.nan)
    want_bodies = {
        "sum_one_instance": {None: np.nansum(want[one], axis=0)},
        "group_by_instance": {i: np.nansum(want[inst == i], axis=0)
                              for i in np.unique(inst)},
        "per_second_one_instance": dict(zip(np.array(ids)[one].tolist(),
                                            per_second))}
    out = {}
    for name, target in SAT_RENDERS.items():
        body, ms = c.json("/render", target=target, **{
            "from": str(frm // 1000), "until": str(until // 1000)})
        got = {}
        for s in body:
            key = {"sum_one_instance": None,
                   "group_by_instance": s["tags"].get("instance"),
                   "per_second_one_instance": s["tags"].get("id")}[name]
            if [p[1] * 1000 for p in s["datapoints"]] != grid.tolist():
                raise AssertionError(f"satellites render {name}: grid")
            got[key] = np.array([np.nan if p[0] is None else p[0]
                                 for p in s["datapoints"]])
        w = want_bodies[name]
        if sorted(map(str, got)) != sorted(map(str, w)) or not all(
                np.array_equal(got[k], np.where(np.isnan(w[k]), np.nan,
                                                w[k]), equal_nan=True)
                for k in w):
            raise AssertionError(f"satellites render {name}: not the numpy "
                                 f"version")
        out[name] = {"round_trip_ms": ms, "series": len(body),
                     "body_bytes": c.last["body_bytes"], "vs_numpy": "equal"}
    found, _ = c.json("/metrics/find", query="*")
    tags, _ = c.json("/tags")
    if SELECTOR not in {n["text"] for n in found} or \
            not {"instance", "id"} <= {t["tag"] for t in tags}:
        raise AssertionError("satellites: /metrics/find or /tags")
    # a plaintext line through the Graphite listener, rendered back
    (listener,) = [s for s in api.ingest_servers if s.proto == "graphite"]
    import socket
    with socket.create_connection(("127.0.0.1", listener.port), 10) as sk:
        sk.sendall(f"satellites.graphite.line 1.5 {t_last // 1000}\n"
                   .encode())
    deadline = time.perf_counter() + 30
    while True:
        body, _ = c.json("/render", target="satellites.graphite.line", **{
            "from": str((t_last - 600_000) // 1000),
            "until": str(t_last // 1000)})
        if body and 1.5 in [p[0] for p in body[0]["datapoints"]]:
            break
        if time.perf_counter() > deadline:
            raise AssertionError("satellites: the Graphite line was not "
                                 "rendered back")
        time.sleep(0.1)
    out["find_nodes"] = len(found)
    out["tags"] = len(tags)
    out["listener_line"] = "rendered back"
    return out


def phase_satellites(st) -> dict:
    """The port's vmsingle on the http phase's store, started as a user
    starts it (no backend flag: the card by default) with -rule and
    -graphiteListenAddr: (a) server-side rules on the card, (b) the
    standalone vmalert against it, (c) vmagent through its queue, (d)
    Graphite.  Its launch counts are the server's, vmalert's queries
    included.  The server goes on serving in ``st["served"]`` for the
    operations phase, which stops it (a failure here stops it at once)."""
    from victoriametrics_tpu_torch.apps import vmsingle
    from victoriametrics_tpu_torch.utils import profiler
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_satellites_")
    rrc.GLOBAL.reset()
    threshold = st["threshold"]
    rules_path = os.path.join(tmp, "rules.json")
    with open(rules_path, "w") as f:
        json.dump(sat_rules(threshold), f)
    t0 = time.perf_counter()
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={st['path']}", "-httpListenAddr=127.0.0.1:0",
        f"-rule={rules_path}", "-graphiteListenAddr=127.0.0.1:0"]))
    attach_s = time.perf_counter() - t0
    for g in api.rule_groups:
        g.stop()  # evaluated below on the data's clock
    srv.start()
    parts, handed = {}, False
    try:
        if not isinstance(api.tpu, ce.CUDAEngine):
            raise AssertionError("satellites: the default backend attached "
                                 f"{api.tpu!r}")
        c = HttpClient(srv.port)
        kernels.reset_launches()
        instants = [st["end"] + k * DASH_STEP for k in range(3)]
        t0 = time.perf_counter()
        rules = sat_rules_server(c, api, st, instants)
        parts["rules_s"] = time.perf_counter() - t0
        server_rows = rules.pop("written")
        t0 = time.perf_counter()
        alert = sat_vmalert(srv.port, rules_path, instants, server_rows)
        parts["vmalert_s"] = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES.get(k, 0) for k in SOURCES}
        t0 = time.perf_counter()
        graphite = sat_graphite(c, st, api, instants[-1])
        parts["graphite_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        agent = sat_vmagent(tmp, st, api, c.base, instants[-1] + DASH_STEP)
        parts["vmagent_s"] = time.perf_counter() - t0
        # the operations phase runs next against this server, and stops it
        st["served"], st["last_instant"] = (storage, srv, api), instants[-1]
        handed = True
    finally:
        if not handed:
            vmsingle.shutdown(srv, storage, api)
            profiler.PROFILER.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "satellites", "ok": True,
           "attach": {**getattr(api, "attach_timing", {}),
                      "attach_s": attach_s, "flag": "default",
                      "device": str(api.tpu.device)},
           "threshold": threshold, "rules": rules, "vmalert": alert,
           "vmagent": agent, "graphite": graphite, "part_s": parts,
           "wall_s": time.perf_counter() - t_phase, "launches": launches}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The operations phase: vmauth, vmbackup/vmrestore and vmctl around vmsingle.
# ---------------------------------------------------------------------------

#: the vmauth users: basic auth, a bearer token, and a JWT (HS256) user
#: whose token must carry OPS_CLAIM; each routes the query API to S
OPS_USER, OPS_PASSWORD, OPS_TOKEN = "dashboards", "ops-pw", "ops-token"
OPS_JWT_SECRET, OPS_CLAIM = "ops-jwt-secret", {"team": "dashboards"}
#: the TSDB block vmctl migrates: the dashboard's series of these
#: instances (32 each), renamed, over the last hour of the seeded history
OPS_TSDB_INSTANCES = [f"host-{i}" for i in range(8)]
OPS_TSDB_METRIC = "tsdb_requests_total"
OPS_TSDB_SAMPLES = 240
OPS_SUM = PANEL_TEXTS["sum_by_instance"]
OPS_TSDB_SUM = f"sum by (instance)(rate({OPS_TSDB_METRIC}[5m]))"
OPS_TSDB_WANT = ("sum by (instance)(rate(" + SELECTOR +
                 '{instance=~"host-[0-7]"}[5m]))')


def app_env() -> dict:
    """The environment of an app process: this checkout on PYTHONPATH,
    no card (the apps around vmsingle never touch one)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return {**os.environ, "CUDA_VISIBLE_DEVICES": "",
            "PYTHONPATH": os.pathsep.join(
                p for p in (here, os.environ.get("PYTHONPATH")) if p)}


def run_app(module: str, *flags, timeout: float = 600) -> dict:
    """``python -m victoriametrics_tpu_torch.apps.<module>`` run to its
    end: its output and wall seconds; a non-zero exit raises."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", f"victoriametrics_tpu_torch.apps.{module}",
         *flags], env=app_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"{module} {flags[:1]}: exit {out.returncode}: "
                             f"{out.stdout[-2000:]}")
    return {"output": out.stdout, "wall_s": time.perf_counter() - t0}


def logged(what: str, pattern: str, text: str) -> tuple[int, ...]:
    """The integers of `pattern`'s first match in an app's log."""
    hit = re.search(pattern, text)
    if hit is None:
        raise AssertionError(f"{what}: no {pattern!r} in {text[-2000:]!r}")
    return tuple(int(x) for x in hit.groups())


class AuthProc:
    """vmauth as a process (``python -m victoriametrics_tpu_torch.apps.
    vmauth``) with a JSON -auth.config, on a port read from its start
    line."""

    def __init__(self, cfg_path: str, log_path: str):
        self.log_path = log_path
        with open(log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "victoriametrics_tpu_torch.apps.vmauth",
                 f"-auth.config={cfg_path}", "-httpListenAddr=127.0.0.1:0"],
                stdout=log, stderr=subprocess.STDOUT, env=app_env(),
                cwd=os.path.dirname(os.path.abspath(__file__)))
        t_end = time.monotonic() + 120
        while True:
            with open(log_path) as f:
                text = f.read()
            hit = re.search(r"vmauth started: http=(\d+)", text)
            if hit:
                self.port = int(hit.group(1))
                return
            if self.proc.poll() is not None or time.monotonic() > t_end:
                self.stop()
                raise AssertionError(f"vmauth did not start: {text[-2000:]}")
            time.sleep(0.05)

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                return self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return self.proc.wait()


def hs256_token(secret: str, claims: dict) -> str:
    """A JWT (HS256) over `claims`."""
    import base64
    import hashlib
    import hmac

    def b64(b: bytes) -> str:
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()
    head = b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = b64(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(),
                   hashlib.sha256).digest()
    return f"{head}.{body}.{b64(sig)}"


def auth_header(auth: str | None) -> dict | None:
    return {"Authorization": auth} if auth else None


def ops_range(what: str, c: HttpClient, q: str, grid, auth=None, **kw):
    """A query_range over `grid` (start, end, step ms) that must answer
    200, `auth` as its Authorization header: its keyed result, launches
    and round trip ms."""
    before = dict(kernels.LAUNCHES)
    code, body, ms = c.get("/api/v1/query_range", auth_header(auth), query=q,
                           start=grid[0] / 1e3, end=grid[1] / 1e3,
                           step=grid[2] / 1e3, **kw)
    if code != 200:
        raise AssertionError(f"{what}: {code} {body[:300]}")
    return body_result(json.loads(body)), launched_since(before), ms


def require_route(what: str, launches: dict, cold: bool) -> None:
    """K2 launched, and K1 too when the query is cold."""
    if not launches.get("rollup_aggregate_tile") or (
            cold and not launches.get("decode_tiles")):
        raise AssertionError(f"{what}: launched {launches}")


def ops_vmauth(tmp: str, s: HttpClient, grid) -> dict:
    """(a) vmauth in front of S: the dashboard's sum panel through each of
    its three users equal as strings to the request sent to S directly,
    and with nocache=1 at the same launches; a wrong password, a JWT whose
    claim is wrong and an empty basic credential answer 401."""
    import base64
    route = [{"src_paths": ["/api/v1/query_range", "/api/v1/query"],
              "url_prefix": s.base}]
    cfg = os.path.join(tmp, "auth.json")
    with open(cfg, "w") as f:
        json.dump({"users": [
            {"username": OPS_USER, "password": OPS_PASSWORD, "url_map": route},
            {"bearer_token": OPS_TOKEN, "url_map": route},
            {"name": "jwt", "jwt_secrets": [OPS_JWT_SECRET],
             "jwt_required_claims": OPS_CLAIM, "url_map": route}]}, f)
    basic = "Basic " + base64.b64encode(
        f"{OPS_USER}:{OPS_PASSWORD}".encode()).decode()
    users = {"basic": basic, "bearer": f"Bearer {OPS_TOKEN}",
             "jwt": "Bearer " + hs256_token(OPS_JWT_SECRET, OPS_CLAIM)}
    t0 = time.perf_counter()
    proxy = AuthProc(cfg, os.path.join(tmp, "vmauth.log"))
    out = {"start_s": time.perf_counter() - t0}
    try:
        p = HttpClient(proxy.port)
        # the panel as the dashboard sends it: directly, through each user,
        # directly again (after the first, from S's result cache: no
        # launch); then with nocache=1 (no result cache, no resident
        # window: K2 on the engine's tile, K1 too where the tile is not
        # cached) through vmauth and directly, the pair whose launches
        # must match
        first, first_l, first_ms = ops_range("ops direct", s, OPS_SUM, grid)
        proxied = {}
        for name, auth in users.items():
            got, launches, ms = ops_range(f"ops vmauth {name}", p, OPS_SUM,
                                          grid, auth)
            same_strings(f"ops vmauth {name}", got, first)
            proxied[name] = {"round_trip_ms": ms, "launches": launches}
        direct, direct_l, direct_ms = ops_range("ops direct", s, OPS_SUM,
                                                grid)
        same_strings("ops direct again", direct, first)
        cold = {}
        for name, c, auth in (("vmauth", p, users["basic"]),
                              ("direct", s, None)):
            got, launches, ms = ops_range(f"ops nocache {name}", c, OPS_SUM,
                                          grid, auth, nocache=1)
            require_route(f"ops nocache {name}", launches, cold=False)
            same_strings(f"ops nocache {name}", got, first)
            cold[name] = {"round_trip_ms": ms, "launches": launches}
        if cold["vmauth"]["launches"] != cold["direct"]["launches"]:
            raise AssertionError(f"ops vmauth nocache: launched "
                                 f"{cold['vmauth']['launches']}, directly "
                                 f"{cold['direct']['launches']}")
        wrong = "Basic " + base64.b64encode(
            f"{OPS_USER}:wrong".encode()).decode()
        claim = "Bearer " + hs256_token(OPS_JWT_SECRET, {"team": "other"})
        # ":" base64-encoded: no user of this config has an empty
        # username, so it names none
        empty = "Basic " + base64.b64encode(b":").decode()
        denied = {}
        for name, auth in (("wrong_password", wrong), ("jwt_claim", claim),
                           ("empty_basic", empty)):
            code, _, _ = p.get("/api/v1/query_range", auth_header(auth),
                               query=OPS_SUM)
            if code != 401 or p.headers.get("WWW-Authenticate") != \
                    'Basic realm="vmauth"':
                raise AssertionError(f"ops vmauth {name}: {code}")
            denied[name] = code
    finally:
        rc = proxy.stop()
    if rc != 0:
        raise AssertionError(f"vmauth exited {rc}")
    return {**out, "first": {"round_trip_ms": first_ms, "launches": first_l},
            "proxied": proxied,
            "direct": {"round_trip_ms": direct_ms, "launches": direct_l},
            "nocache": cold, "series": len(direct), "equal": "strings",
            "denied": denied, "exit": rc}


def tree_bytes(path: str) -> tuple[int, int]:
    """(files, bytes) under a directory."""
    n = size = 0
    for dp, _, fns in os.walk(path):
        for fn in fns:
            n += 1
            size += os.path.getsize(os.path.join(dp, fn))
    return n, size


def series_count(c: HttpClient, what: str) -> int:
    code, body, _ = c.get("/api/v1/series", **{"match[]": SELECTOR,
                                               "start": (T_START - DAY) / 1e3,
                                               "end": time.time()})
    if code != 200:
        raise AssertionError(f"{what} /api/v1/series: {code} {body[:300]}")
    return len(json.loads(body)["data"])


def ops_backup(tmp: str, s_path: str, s: HttpClient) -> tuple[dict, str]:
    """(b) vmbackup of S through its /snapshot/create to fs://, twice (the
    second uploads nothing), main_restore into a new directory: the counts,
    bytes and seconds, and the restored path."""
    from victoriametrics_tpu_torch.apps import vmbackup
    dst = os.path.join(tmp, "backup")
    flags = [f"-storageDataPath={s_path}", f"-dst=fs://{dst}"]
    first = run_app("vmbackup", f"-snapshot.createURL={s.base}", *flags)
    up, skip, deleted = logged("vmbackup", r"backup: uploaded=(\d+) "
                               r"skipped=(\d+) deleted=(\d+)",
                               first["output"])
    code, body, _ = s.get("/snapshot/list")
    (snap,) = json.loads(body)["snapshots"]
    again = run_app("vmbackup", f"-snapshotName={snap}", *flags)
    up2, skip2, deleted2 = logged("vmbackup again", r"backup: uploaded="
                                  r"(\d+) skipped=(\d+) deleted=(\d+)",
                                  again["output"])
    if up == 0 or skip or (up2, skip2, deleted2) != (0, up, 0):
        raise AssertionError(f"ops vmbackup: {up}/{skip} then {up2}/{skip2}"
                             f"/{deleted2}")
    files, size = tree_bytes(dst)
    restored = os.path.join(tmp, "restored")
    t0 = time.perf_counter()
    vmbackup.main_restore([f"-src=fs://{dst}",
                           f"-storageDataPath={restored}"])
    restore_s = time.perf_counter() - t0
    if tree_bytes(restored) != (files, size):
        raise AssertionError("ops vmrestore: other files than the backup's")
    return {"snapshot": snap, "backup_s": first["wall_s"],
            "uploaded": up, "backup_files": files, "backup_bytes": size,
            "again_s": again["wall_s"], "again_uploaded": up2,
            "again_skipped": skip2, "restore_s": restore_s}, restored


def ops_restored(s: HttpClient, d: HttpClient, grid) -> dict:
    """(b) D's cold sum panel (K1 + K2) equal as strings to S's nocache=1
    answer; 8192 series on both."""
    got, launches, ms = ops_range("ops restored D", d, OPS_SUM, grid)
    require_route("ops restored D", launches, cold=True)
    want, s_launches, s_ms = ops_range("ops S nocache", s, OPS_SUM, grid,
                                       nocache=1)
    same_strings("ops restored D vs S", got, want)
    counts = {"S": series_count(s, "S"), "D": series_count(d, "D")}
    if counts != {"S": DASH_SERIES, "D": DASH_SERIES}:
        raise AssertionError(f"ops series: {counts}")
    return {"round_trip_ms": ms, "launches": launches, "s_round_trip_ms":
            s_ms, "s_launches": s_launches, "series": counts,
            "groups": len(got), "equal": "strings"}


def ops_native(st, s: HttpClient, d: HttpClient, d_api, after: int,
               span: int) -> dict:
    """(c) one steady scrape of the 8192 series written to S after the
    snapshot, copied to D by vmctl vm-native filtered from that scrape:
    8192 series, and exactly their 8192 samples inserted into D (D's
    vm_rows_inserted_total; the whole history would be 1441 a series);
    then the sum panel over a window ending at that scrape on D (the card)
    against S's nocache=1 answer."""
    sat_scrape(s, st, after)
    ts = st["feed"].history[-1][0]
    t_from = int(ts.min())
    inserted0 = d_api.rows_inserted
    run = run_app("vmctl", "vm-native", f"--vm-native-src-addr={s.base}",
                  f"--vm-native-dst-addr={d.base}",
                  "--vm-native-filter-match={__name__=\"%s\"}" % SELECTOR,
                  f"--vm-native-filter-time-start={t_from / 1e3}")
    (rows,) = logged("vmctl vm-native", r"migrated (\d+) series chunks",
                     run["output"])
    samples = d_api.rows_inserted - inserted0
    if rows != DASH_SERIES or samples != DASH_SERIES:
        raise AssertionError(f"ops vm-native: {rows} series, {samples} "
                             "samples inserted")
    code, body, _ = d.get("/internal/force_flush")
    if code != 200:
        raise AssertionError(f"ops D force_flush: {code}")
    end = int(ts.max()) + DASH_STEP - int(ts.max()) % DASH_STEP
    grid = (end - span, end, DASH_STEP)
    # as the dashboard asks: D's resident window from (b) takes the new
    # scrape (K3 appends it, K2), at rtol 1e-12 of S's cold answer; with
    # nocache=1 D takes S's route (K1 + K2 on the migrated columns), and
    # the two answers are the same strings
    got, launches, ms = ops_range("ops migrated D", d, OPS_SUM, grid)
    require_route("ops migrated D", launches, cold=False)
    cold, cold_l, cold_ms = ops_range("ops migrated D nocache", d, OPS_SUM,
                                      grid, nocache=1)
    require_route("ops migrated D nocache", cold_l, cold=True)
    want, s_launches, s_ms = ops_range("ops S nocache", s, OPS_SUM, grid,
                                       nocache=1)
    require_route("ops S nocache", s_launches, cold=True)
    same_strings("ops migrated D vs S", cold, want)
    err = keyed_close("ops migrated D (its window) vs S", got, want, 1e-12,
                      0.0)
    return {"vmctl_s": run["wall_s"], "rows": rows, "samples": samples,
            "from_ms": t_from,
            "grid": list(grid), "round_trip_ms": ms, "launches": launches,
            "max_abs_err": err, "rtol": 1e-12,
            "nocache": {"round_trip_ms": cold_ms, "launches": cold_l,
                        "equal": "strings"},
            "s_round_trip_ms": s_ms, "s_launches": s_launches}


def ops_tsdb(tmp: str, st, s: HttpClient, d: HttpClient) -> dict:
    """(d) the dashboard's series of host-0..host-7 (32 each) over the
    last hour of the seeded history, renamed, written as one Prometheus
    TSDB block by the port's promtsdb.write_block; vmctl verify-block
    passes it and vmctl prometheus-tsdb migrates it into D; the sum by
    instance of its rate on D (the card) within rtol 1e-12 of S's over the
    same series and hour."""
    from victoriametrics_tpu_torch.utils import promtsdb
    ts, vals = (a[:, -OPS_TSDB_SAMPLES:] for a in st["tail"])
    keep = [i for i, lb in enumerate(st["labels"])
            if lb["instance"] in OPS_TSDB_INSTANCES]
    series = [({**st["labels"][i], "__name__": OPS_TSDB_METRIC}, ts[i],
               vals[i]) for i in keep]
    blk = os.path.join(tmp, "tsdb", "01OPSBLOCK")
    t0 = time.perf_counter()
    promtsdb.write_block(blk, series)
    write_s = time.perf_counter() - t0
    verify = run_app("vmctl", "verify-block", f"--block-path={blk}")
    rep = json.loads(verify["output"][verify["output"].index("{"):
                                      verify["output"].rindex("}") + 1])
    n_samples = len(keep) * OPS_TSDB_SAMPLES
    if not rep["ok"] or rep["samples"] != n_samples:
        raise AssertionError(f"ops verify-block: {rep}")
    run = run_app("vmctl", "prometheus-tsdb",
                  f"--tsdb-path={os.path.dirname(blk)}",
                  f"--dst-addr={d.base}")
    (migrated,) = logged("vmctl prometheus-tsdb", r"migrated (\d+) samples",
                         run["output"])
    if migrated != n_samples:
        raise AssertionError(f"ops prometheus-tsdb: {migrated} samples")
    code, _, _ = d.get("/internal/force_flush")
    if code != 200:
        raise AssertionError(f"ops D force_flush: {code}")
    # windows inside the hour, with the sample before each inside it too
    lo = int(ts[keep, 0].max()) + 2 * WINDOW
    hi = int(ts[keep, -1].min())
    grid = (lo + DASH_STEP - lo % DASH_STEP, hi - hi % DASH_STEP, DASH_STEP)
    got, launches, ms = ops_range("ops tsdb D", d, OPS_TSDB_SUM, grid)
    require_route("ops tsdb D", launches, cold=True)
    want, s_launches, s_ms = ops_range("ops tsdb S", s, OPS_TSDB_WANT, grid,
                                       nocache=1)
    err = keyed_close("ops tsdb D vs S", got, want, 1e-12, 0.0)
    return {"series": len(keep), "samples": n_samples, "write_block_s":
            write_s, "block_bytes": tree_bytes(blk)[1],
            "verify_s": verify["wall_s"], "vmctl_s": run["wall_s"],
            "migrated": migrated, "grid": list(grid), "groups": len(got),
            "round_trip_ms": ms, "launches": launches,
            "s_round_trip_ms": s_ms, "s_launches": s_launches,
            "max_abs_err": err, "rtol": 1e-12}


def phase_operations(st) -> dict:
    """vmauth, vmbackup/vmrestore and vmctl around the satellites phase's
    vmsingle S (still serving, on the card): (a) the sum panel through
    vmauth; (b) S backed up twice through its /snapshot/create, restored
    with main_restore, and vmsingle D started on the restored directory
    with the default backend (the phase's one attach), D's cold sum panel
    against S's; (c) a scrape written to S after the snapshot, copied to D
    by vmctl vm-native, the sum over it on D against S's; (d) a TSDB block
    of 256 dashboard series, verified and migrated by vmctl into D, its
    sum by instance on D against S's.  The apps run as processes, as users
    run them.  Its launch counts are S's and D's, D's attach included
    (its warm-up launches K1 once, K2 and B5 three times each)."""
    from victoriametrics_tpu_torch.apps import vmsingle
    from victoriametrics_tpu_torch.utils import profiler
    t_phase = time.perf_counter()
    storage, srv, api = st.pop("served")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_operations_")
    parts, d_server = {}, None
    try:
        s = HttpClient(srv.port)
        start, end = dashboard_grid()
        start -= start % DASH_STEP
        end = start + -(-(end - start) // DASH_STEP) * DASH_STEP
        grid = (start, end, DASH_STEP)
        kernels.reset_launches()
        t0 = time.perf_counter()
        auth = ops_vmauth(tmp, s, grid)
        parts["vmauth_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backup, restored = ops_backup(tmp, st["path"], s)
        parts["backup_restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d_server = vmsingle.build(vmsingle.parse_flags([
            f"-storageDataPath={restored}", "-httpListenAddr=127.0.0.1:0"]))
        attach_s = time.perf_counter() - t0
        d_storage, d_srv, d_api = d_server
        if not isinstance(d_api.tpu, ce.CUDAEngine):
            raise AssertionError("operations: D's default backend attached "
                                 f"{d_api.tpu!r}")
        d_srv.start()
        d = HttpClient(d_srv.port)
        attach = {**d_api.attach_timing, "attach_s": attach_s,
                  "flag": "default", "device": str(d_api.tpu.device)}
        t0 = time.perf_counter()
        backup["restored_query"] = ops_restored(s, d, grid)
        parts["restored_query_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = ops_native(st, s, d, d_api, st["last_instant"],
                            end - start)
        parts["vm_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tsdb = ops_tsdb(tmp, st, s, d)
        parts["prometheus_tsdb_s"] = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES.get(k, 0) for k in SOURCES}
    finally:
        if d_server is not None:
            vmsingle.shutdown(d_server[1], d_server[0], d_server[2])
        vmsingle.shutdown(srv, storage, api)
        profiler.PROFILER.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "operations", "ok": True, "attach": attach,
           "vmauth": auth, "backup": backup, "vm_native": native,
           "prometheus_tsdb": tsdb, "part_s": parts,
           "wall_s": time.perf_counter() - t_phase, "launches": launches}
    emit(res)
    return res


def full_width_queries(engine, series, cfg, key, gids, G, dev) -> dict:
    """The slice-2 queries on the resident full-width tile, each with its
    own launch counts: topk(10, rate), topk_median(10, rate), avg by
    (instance)(deriv), and an instant quantile(0.99, rate) over every
    series at the range's end; then each held against the plain versions
    (rows in chunks, steps in chunks)."""
    S = len(series)
    ts_t, v_t, counts = engine.cache().get(key)
    ncfg = dr.normalized_cfg("rate", cfg)
    T = dr.num_steps(ncfg)
    t_end = cfg.end
    icfg = RollupConfig(t_end, t_end, FULL_STEP, WINDOW)
    shift, i_min_ts = t_end - cfg.start, -(WINDOW + LOOKBACK_DELTA)
    one = dr.group_layout(np.zeros(S, np.int32), 1, dev)
    queries = {
        "topk": (ce.try_topk_rollup, ("topk", 10, "rate", series, cfg),
                 {"cache_key": key}),
        "topk_median": (ce.try_topk_rollup, ("topk_median", 10, "rate",
                                             series, cfg),
                        {"cache_key": key}),
        "avg_deriv_by_instance": (ce.try_aggr_rollup, (
            "avg", "deriv", series, gids, G, cfg), {"cache_key": key}),
        "instant_quantile": (ce.run_quantile_on_tiles, (
            0.99, "rate", (ts_t, v_t, counts), one, icfg, shift, i_min_ts),
            {}),
    }
    out, got = {}, {}
    for name, (fn, args, kw) in queries.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        got[name] = fn(engine, *args, **kw)
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "launches": dict(kernels.LAUNCHES)}
        if got[name] is None:
            raise AssertionError(f"full width {name}: declined")
        check_launched("full width", name, out[name]["launches"])
    # the gate declines a full-width range quantile, as the reference's does
    if ce.quantile_dense_fits(engine, 1, S, cfg) or \
            ce.quantile_dense_fits(engine, G, S // G, cfg) or \
            ce.try_quantile_rollup(engine, 0.99, "rate", series,
                                   np.zeros(S, np.int32), 1, cfg, S,
                                   cache_key=key) is not None:
        raise AssertionError("full width: a range quantile was admitted")

    # checks, against the plain versions
    rolled = dr.rollup_tile("rate", ts_t, v_t, counts, ncfg)
    drv = torch.zeros((G, T), dtype=torch.float64, device=dev)
    drv_n = torch.zeros_like(drv)
    ranks = {k: dr.rank_rows(rolled, k) for k in dr.RANK_KINDS}
    rank = ranks["median"]
    chunk = 4096
    err5 = 0.0
    for r0 in range(0, S, chunk):
        sl = slice(r0, r0 + chunk)
        w = dr.rollup_tile_plain("rate", ts_t[sl], v_t[sl], counts[sl], ncfg)
        err5 = max(err5, func_close(f"full width B5 rows {r0}+", "rate",
                                    rolled[sl], w))
        # B7, every kind, as check_ranks holds them
        for k, r in ranks.items():
            w = dr.rank_rows_plain(rolled[sl], k)
            if k in ("median", "last"):
                assert_exact(f"full width B7 {k} rows {r0}+", r[sl], w)
            else:
                assert_close(f"full width B7 {k} rows {r0}+", r[sl], w,
                             1e-12 if k == "avg" else 0.0, 0.0)
        d = dr.rollup_tile_plain("deriv", ts_t[sl], v_t[sl], counts[sl],
                                 ncfg)
        live = ~torch.isnan(d)
        g = torch.from_numpy(gids[r0:r0 + chunk]).to(dev).long()
        drv.index_add_(0, g, torch.where(live, d, 0.0))
        drv_n.index_add_(0, g, live.double())
        del w, d, live
    aggr_close("full width K2 avg(deriv)", "avg",
               torch.from_numpy(got["avg_deriv_by_instance"]),
               (drv / drv_n).cpu(), "deriv")
    idx, sel_nan = dr.topk_select(rolled, 10, False)
    # k = 20, as k = 10, takes B6's scan path (k <= K_REG)
    idx20, nan20 = dr.topk_select(rolled, 20, False)
    for t0 in range(0, T, 512):
        wi, wn = dr.topk_select_plain(rolled[:, t0:t0 + 512].contiguous(),
                                      20, False)
        assert_equal(f"full width B6 steps {t0}+", idx[t0:t0 + 512],
                     wi[:, :10])
        assert_equal(f"full width B6 nan steps {t0}+",
                     sel_nan[t0:t0 + 512], wn[:, :10])
        assert_equal(f"full width B6 k=20 steps {t0}+", idx20[t0:t0 + 512],
                     wi)
        assert_equal(f"full width B6 k=20 nan steps {t0}+",
                     nan20[t0:t0 + 512], wn)
    del idx20, nan20, wi, wn
    # the sort path (k > K_REG) over all 100,000 rows: a 512-step slice
    part = rolled[:, :512].contiguous()
    k_sort = dr.K_REG + 1
    gi, gn = dr.topk_select(part, k_sort, False)
    wi, wn = dr.topk_select_plain(part, k_sort, False)
    assert_equal(f"full width B6 k={k_sort} 512 steps", gi, wi)
    assert_equal(f"full width B6 k={k_sort} nan 512 steps", gn, wn)
    del gi, gn, wi, wn
    want_sel = np.unique(idx.cpu().numpy()[~sel_nan.cpu().numpy()])
    if [i for i, _ in got["topk"]] != [int(i) for i in want_sel]:
        raise AssertionError("full width topk: other series")
    rank_h = rank.cpu().numpy()
    order = np.argsort(np.where(np.isnan(rank_h), -np.inf, rank_h),
                       kind="stable")
    if [i for i, _ in got["topk_median"]] != [int(i) for i in order[-10:]]:
        raise AssertionError("full width topk_median: other series")
    sel_t = torch.from_numpy(want_sel).to(dev)  # the panel's rows, int64
    b6 = {f"k{k}": three_ms(lambda k=k: dr.topk_select(rolled, k, False),
                            n=10, reps=3) for k in (10, 20)}
    b6[f"k{k_sort}_512_steps"] = three_ms(
        lambda: dr.topk_select(part, k_sort, False), n=3, reps=3)
    b6["plan_k10"] = dr.topk_plan(S, T, 10, kernels.sm_count(dev))._asdict()
    b6["bound_ms"] = topk_bound(S, T, 10)["bound_ms"]
    del part
    # library calls on the same inputs (the key pre-transposed, as at the
    # dashboard shape)
    key = dr._topk_key(rolled, False).T.contiguous()
    library = {f"topk_k{k}": library_or_oom(
        lambda k=k: torch.topk(key, k, dim=1), 10) for k in (10, 20)}
    del key
    library["index_select"] = library_or_oom(
        lambda: torch.index_select(rolled, 0, sel_t), 10)
    library["nanquantile_median"] = library_or_oom(
        lambda: torch.nanquantile(rolled, 0.5, dim=1), 3)
    events = {
        "rollup_tile_ms": cuda_ms(lambda: dr.rollup_tile(
            "rate", ts_t, v_t, counts, ncfg), reps=3),
        "topk_select_ms": b6["k10"]["ms"],
        "topk_select_k20_ms": b6["k20"]["ms"],
        "topk_select": b6,
        "take_rows": {"rows": int(sel_t.numel()), **three_ms(
            lambda: dr.take_rows(rolled, sel_t), n=10, reps=3),
            **take_rows_bound(int(sel_t.numel()), T)},
        "rank_median_ms": cuda_ms(lambda: dr.rank_rows(rolled, "median"),
                                  reps=3),
        "rank_device_ms": {k: device_ms(lambda k=k: dr.rank_rows(rolled, k),
                                        5) for k in dr.RANK_KINDS},
        "nanmean_device_ms": device_ms(
            lambda: torch.nanmean(rolled, dim=1), 5),
        "k2_deriv_avg_ms": cuda_ms(lambda: dr.rollup_aggregate_tile(
            "deriv", "avg", ts_t, v_t, counts,
            dr.group_layout(gids, G, dev), ncfg), reps=3),
    }
    del rolled
    # the plain instant rollup on the CPU, where torch divides by a
    # scalar as the kernels do (on the card it multiplies by the
    # reciprocal, an ulp away): the engine's quantile and B5's rates are
    # held to it bit for bit
    cpu = torch.device("cpu")
    inst = torch.cat([dr.rollup_tile_plain(
        "rate", ts_t[r0:r0 + chunk].cpu() - shift, v_t[r0:r0 + chunk].cpu(),
        counts[r0:r0 + chunk].cpu(), dr.normalized_cfg("rate", icfg),
        i_min_ts) for r0 in range(0, S, chunk)])
    inst_k = dr.rollup_tile("rate", ts_t, v_t, counts,
                            dr.normalized_cfg("rate", icfg), i_min_ts, shift)
    assert_exact("full width instant rate", inst_k.cpu(), inst)
    q_plain = dr.quantile_groups_plain(
        inst, dr.group_layout(np.zeros(S, np.int32), 1, cpu), 0.99)
    assert_exact("full width instant quantile", torch.from_numpy(
        got["instant_quantile"]), q_plain)
    if not np.isfinite(got["instant_quantile"]).all():
        raise AssertionError("full width instant quantile: not finite")
    # B8's cluster path on the instant's one group of every series, bit
    # for bit at every phi
    events["instant_quantile_plan"] = check_quantile(
        "full width instant", inst_k, one,
        (dr.Q_CLUSTER, 16, 1) if S == 100_000 else None)
    events["instant_quantile_ms"] = cuda_ms(
        lambda: dr.quantile_groups(inst_k, one, 0.99), reps=3)
    events["instant_quantile"] = {
        **three_ms(lambda: dr.quantile_groups(inst_k, one, 0.99)),
        **quantile_bound(S, 1, 1)}
    dense = dr.dense_by_group(inst_k, one)
    library["nanquantile_instant"] = library_or_oom(
        lambda: torch.nanquantile(dense, 0.99, dim=1), 50)
    return {"queries": out, "event_ms": events, "library": library,
            "b5_max_abs_err_vs_plain": err5,
            "instant_quantile": float(got["instant_quantile"][0, 0])}


def decode_tap(planes: list):
    """Wrap dd.decode_tiles to keep the planes an engine hands K1; returns
    the restore function."""
    real = dd.decode_tiles

    def tap(*a):
        planes.append(a)
        return real(*a)

    dd.decode_tiles = tap
    return lambda: setattr(dd, "decode_tiles", real)


def full_width_b5(ts_t, v_t, counts, cfg, chunk: int) -> dict:
    """B5 on the full-width tile: rate, deriv and tlast_over_time on the
    plan's path (staged at this shape) against the global search bit for
    bit, compared in row chunks, and the device ms of each path."""
    S, N = ts_t.shape
    res = {}
    for func in ("rate", "deriv", "tlast_over_time"):
        c = dr.normalized_cfg(func, cfg)
        T = dr.num_steps(c)
        plan = dr.b5_plan(S, N, T, c.step, c.lookback,
                          dr.scrape_hint(N, T, c.step, c.lookback),
                          kernels.sm_count(ts_t.device))
        if plan.path != dr.K2_STAGED:
            raise AssertionError(f"full width B5 {func}: plan {plan} is "
                                 "not staged")
        got = dr.rollup_tile(func, ts_t, v_t, counts, c)
        for r0 in range(0, S, chunk):
            sl = slice(r0, r0 + chunk)
            assert_equal(f"full width B5 {func} rows {r0}+ plan vs global",
                         got[sl], dr.rollup_tile(func, ts_t[sl], v_t[sl],
                                                 counts[sl], c,
                                                 force_global=True))
        del got
        res[func] = {"plan": plan._asdict(), "device_ms": device_ms(
            lambda: dr.rollup_tile(func, ts_t, v_t, counts, c), 3),
            "global_device_ms": device_ms(lambda: dr.rollup_tile(
                func, ts_t, v_t, counts, c, force_global=True), 3)}
        torch.cuda.empty_cache()
    return res


def phase_full_width(rng, dev, hours: float) -> dict:
    """BASELINE config 2 as one cold query, with its time split."""
    S, G = FULL_SERIES, FULL_SERIES // FULL_PER_GROUP
    N = int(hours * 3600_000 // SCRAPE)
    if hours != 24:
        print(json.dumps({"cut": {"full_width_hours": hours,
                                  "reference_hours": 24}}), flush=True)
    t0 = time.perf_counter()
    ts, vals = counters(rng, S, N, T_START)
    series = [SeriesData(None, ts[i], vals[i], raw_name=b"c%d" % i)
              for i in range(S)]
    gen_s = time.perf_counter() - t0
    gids = (np.arange(S) % G).astype(np.int32)
    cfg = RollupConfig(T_START, T_START + N * SCRAPE, FULL_STEP, WINDOW)
    engine = ce.CUDAEngine(device=dev, cache_bytes=64 << 30)
    key = ("full_width",)
    up0 = tile_cache.bytes_uploaded()
    torch.cuda.reset_peak_memory_stats(dev)
    # keep the planes the engine hands K1, to hold K1 against its plain
    # version afterwards (the wrapper itself runs and counts as always)
    planes = []
    restore = decode_tap(planes)
    snap = split_snapshot()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = ce.try_aggr_rollup(engine, "sum", "rate", series, gids, G, cfg,
                                 cache_key=key)
    finally:
        restore()
    total = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES.get(name, 0) for name in SOURCES}
    split = split_ms(snap, split_snapshot(), total)
    peak = torch.cuda.max_memory_allocated(dev)
    T = dr.num_steps(cfg)
    if out is None or out.shape != (G, T):
        raise AssertionError("full width: wrong result shape")
    if not np.isfinite(out[:, WINDOW // FULL_STEP + 1:]).all():
        raise AssertionError("full width: non-finite group rates")
    if launches["decode_tiles"] < 1 or launches["rollup_aggregate_tile"] < 1:
        raise AssertionError(f"full width: K1/K2 not launched: {launches}")
    ts_t, v_t, counts = engine.cache().get(key)
    # K1 against its plain version, bit for bit, in row chunks
    args, n_cap = planes[0][:8], planes[0][8]
    chunk = 4096
    for r0 in range(0, S, chunk):
        w_ts, w_v = dd.decode_tiles_plain(
            *(a[r0:r0 + chunk] for a in args), n_cap)
        assert_equal(f"full width K1 ts rows {r0}+", ts_t[r0:r0 + chunk],
                     w_ts)
        assert_equal(f"full width K1 values rows {r0}+", v_t[r0:r0 + chunk],
                     w_v)
        del w_ts, w_v
    k1_device_ms = device_ms(lambda: dd.decode_tiles(*args, n_cap), n=3)
    uploads = upload_paths(
        "full_width_planes", [a.cpu().numpy() for a in args], dev, reps=3)
    del planes  # `args` stay for the mesh phase's B12
    groups = dr.group_layout(gids, G, dev)
    ncfg = dr.normalized_cfg("rate", cfg)
    k2_ms = cuda_ms(lambda: dr.rollup_aggregate_tile(
        "rate", "sum", ts_t, v_t, counts, groups, ncfg), reps=3)
    # plain version in row chunks: per-chunk rollup, summed by group
    cnt = torch.zeros((G, T), dtype=torch.float64, device=dev)
    s1 = torch.zeros_like(cnt)
    for r0 in range(0, S, chunk):
        sl = slice(r0, r0 + chunk)
        rolled = dr.rollup_tile_plain("rate", ts_t[sl], v_t[sl], counts[sl],
                                      ncfg)
        present = ~torch.isnan(rolled)
        g = groups.gids[sl].long()
        cnt.index_add_(0, g, present.double())
        s1.index_add_(0, g, torch.where(present, rolled, 0.0))
        del rolled, present
    plain = torch.where(cnt > 0, s1, torch.nan)
    err = assert_close("full width K2 vs plain", torch.from_numpy(out),
                       plain.cpu(), 1e-12, 0.0)
    del cnt, s1, plain
    # K2's staged windows (512-step tiles here) against B5's global
    # searches: count, group, min and max of rate and deriv equal B5's rows
    # under the plain aggregate, folded over row chunks
    for func in ("rate", "deriv"):
        want = {}
        for r0 in range(0, S, chunk):
            sl = slice(r0, r0 + chunk)
            rolled = dr.rollup_tile(func, ts_t[sl], v_t[sl], counts[sl], ncfg)
            m = dr.partial_group_moments("min", rolled, groups.gids[sl], G)
            m["max"] = dr.partial_group_moments("max", rolled,
                                                groups.gids[sl], G)["max"]
            for k, x in m.items():
                want[k] = x if k not in want else \
                    torch.minimum(want[k], x) if k == "min" else \
                    torch.maximum(want[k], x) if k == "max" else want[k] + x
            del rolled, m
        for aggr in ("count", "group", "min", "max"):
            assert_same_values(
                f"full width K2 {func}/{aggr} vs B5",
                dr.rollup_aggregate_tile(func, aggr, ts_t, v_t, counts, groups,
                                         ncfg),
                dr.finalize_group_moments(aggr, want))
        del want
    b5 = full_width_b5(ts_t, v_t, counts, cfg, chunk)
    slice2 = full_width_queries(engine, series, cfg, key, gids, G, dev)
    res = {"phase": "full_width", "ok": True, "series": S, "groups": G,
           "samples_per_series": N, "hours": hours, "steps": T,
           "tile_cols": int(ts_t.shape[1]),
           "tile_bytes": int(ts_t.numel() * 12),
           "upload_bytes": tile_cache.bytes_uploaded() - up0,
           "generate_s": gen_s, "total_ms": total * 1e3, "split": split,
           "k2_event_ms": k2_ms,
           "k2_bound_ms": (int(counts.sum()) * 12 + S * 12 + G * T * 8) /
           MEM_BYTES_PER_S * 1e3,
           "peak_device_bytes": peak, "launches": launches,
           "k1_bitwise_vs_plain": True, "k1_device_ms": k1_device_ms,
           "k1_plan": dd.k1_plan(n_cap, args[2].element_size(),
                                 args[5].element_size(),
                                 kernels.smem_per_sm(dev))._asdict(),
           "max_abs_err_vs_plain": err,
           "uploads": uploads, "b5": b5, "slice2": slice2}
    emit(res)
    return res, {"engine": engine, "series": series, "cfg": cfg,
                 "gids": gids, "key": key, "out": out, "N": N,
                 "ts": ts, "vals": vals, "planes": (args, n_cap)}


def host_codec_store(rng, kind: str):
    """A small store as (ts, values) pairs, series of 1-8 samples (the
    scalar conversion's) among longer ones: "decimal" (counters, a third
    divided by 100, and 3-digit gauges; fits int32 planes) or "mixed"
    (those, full-precision floats and NaN, +-Inf and staleness markers;
    its mantissas leave int32, so both paths pack no planes)."""
    out = []
    for i in range(96):
        n = int(rng.integers(1, 9)) if i % 6 == 0 else \
            int(rng.integers(9, 600))
        ts = np.sort(T_START + np.arange(n, dtype=np.int64) * SCRAPE +
                     rng.integers(-JITTER, JITTER + 1, n))
        v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        if i % 3 == 1:
            v /= 100
        elif i % 3 == 2:
            v = np.round(rng.uniform(-100, 100, n), 3)
        if kind == "mixed" and i % 4 == 1:
            v = rng.standard_normal(n) * np.exp(rng.uniform(-30, 30, n))
        elif kind == "mixed" and i % 4 == 3:
            v[rng.random(n) < 0.2] = (np.nan, np.inf, -np.inf,
                                      dec.STALE_NAN)[i % 8 // 2]
        out.append((ts, v))
    return out


def check_decimal_columns(what: str, series, cols) -> None:
    """The grouped conversion's columns against float_to_decimal on each
    series, bit for bit."""
    m, starts, exps = cols
    for i, sd in enumerate(series):
        want_m, want_e = dec.float_to_decimal(sd.values)
        got_m = m[starts[i]:starts[i] + want_m.size]
        if int(exps[i]) != want_e or not np.array_equal(got_m, want_m):
            raise AssertionError(f"{what}: series {i} converts otherwise "
                                 "than float_to_decimal")


def check_planes(what: str, got, want) -> None:
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {f.name} differs")


def host_codec_round_trips(series, m, starts) -> dict:
    """marshal_int64_array / unmarshal_int64_array, marshal_timestamps and
    marshal_values through the native codec and through numpy: the same
    bytes, and each decodes back to its input."""
    blocks = []
    for i in range(0, len(series), max(1, len(series) // 64)):
        sd = series[i]
        blocks.append(("timestamps", sd.timestamps))
        blocks.append(("values", m[starts[i]:starts[i] + sd.values.size]))
    rng = np.random.default_rng(11)
    blocks += [("array", rng.integers(-1000, 1000, 4096)),  # a gauge
               ("array", np.full(300, 7)), ("array", np.arange(0, 9000, 15)),
               ("array", np.cumsum(np.tile([1, 2, 3, 4], 2048)))]
    marshal = {"array": enc.marshal_int64_array,
               "timestamps": enc.marshal_timestamps,
               "values": enc.marshal_values}
    unmarshal = {"array": enc.unmarshal_int64_array,
                 "timestamps": enc.unmarshal_timestamps,
                 "values": enc.unmarshal_values}
    res, types = {}, collections.Counter()
    saved = enc._HAVE_NATIVE
    try:
        outs = {}
        for path in ("native", "numpy"):
            enc._HAVE_NATIVE = path == "native"
            t0 = time.perf_counter()
            outs[path] = [marshal[k](np.asarray(b, np.int64))
                          for k, b in blocks]
            res[f"{path}_marshal_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for (k, b), (data, mt, first) in zip(blocks, outs[path]):
                back = unmarshal[k](data, mt, first, len(b))
                if not np.array_equal(back, b):
                    raise AssertionError(f"codec round trip ({path}, {k}, "
                                         f"{mt.name}) differs")
            res[f"{path}_unmarshal_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        enc._HAVE_NATIVE = saved
    if outs["native"] != outs["numpy"]:
        raise AssertionError("codec: native and numpy bytes differ")
    for _, mt, _ in outs["native"]:
        types[mt.name] += 1
    return {**res, "blocks": len(blocks),
            "bytes": sum(len(d) for d, _, _ in outs["native"]),
            "samples": int(sum(len(b) for _, b in blocks)),
            "marshal_types": dict(types)}


def phase_host_codec(rng, replay, fw) -> dict:
    """The cold upload's host half: the native codec loaded (no silent
    numpy fallback), the grouped conversion and flat pack timed on the
    dashboard's and the full width's series (the script's own calls of
    the engine's functions, after their cold queries), their planes held
    bit for bit against the per-series path (planes_for, at the dashboard
    and on two small stores) and against the planes K1 decoded at full
    width; then the block codecs' round trips, native against numpy."""
    lib = native.build()
    if not native.available():
        raise AssertionError(f"native codec {lib.name} built but not loaded")
    res = {"phase": "host_codec", "ok": True, "native": {
        "library": lib.name, "has_zstd": native.has_zstd(),
        "decompress_caps": native.decompress_caps()}}
    start, end = dashboard_grid()
    series = replay["store"].search_series(
        FILTERS, start - WINDOW - LOOKBACK_DELTA, end, tenant=TENANT)
    t0 = time.perf_counter()
    cols = ce.decimal_columns(series)
    t1 = time.perf_counter()
    planes = ce.pack_columns(series, *cols, start)
    t2 = time.perf_counter()
    want, n_cap = planes_for([(sd.timestamps, sd.values) for sd in series],
                             start)
    t3 = time.perf_counter()
    check_decimal_columns("dashboard", series, cols)
    check_planes("dashboard planes vs the per-series path", planes, want)
    res["dashboard"] = {
        "series": len(series), "samples": int(cols[0].size),
        "f2d_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3,
        "per_series_ms": (t3 - t2) * 1e3, "n_cap": n_cap,
        "d2_types": [str(planes.ts_d2.dtype), str(planes.val_d2.dtype)]}
    res["codec"] = host_codec_round_trips(series, cols[0], cols[1])
    del want, planes, cols
    small = {}
    for kind in ("decimal", "mixed"):
        pairs = host_codec_store(rng, kind)
        sds = [SeriesData(None, t, v) for t, v in pairs]
        cols = ce.decimal_columns(sds)
        check_decimal_columns(f"{kind} store", sds, cols)
        got = ce.host_planes(sds, T_START)
        if kind == "decimal":
            check_planes(f"{kind} store planes", got,
                         planes_for(pairs, T_START)[0])
        elif got is not None or dd.pack_delta_planes(
                [(t, *dec.float_to_decimal(v)) for t, v in pairs],
                T_START) is not None:
            raise AssertionError("mixed store: planes where its mantissas "
                                 "leave int32")
        small[kind] = {"series": len(sds), "samples": int(cols[0].size),
                       "planes": got is not None}
    res["small"] = small
    series, cfg = fw["series"], fw["cfg"]
    t0 = time.perf_counter()
    cols = ce.decimal_columns(series)
    t1 = time.perf_counter()
    planes = ce.pack_columns(series, *cols, cfg.start)
    t2 = time.perf_counter()
    del cols
    args, n_cap = fw["planes"]
    for f, t in zip(dataclasses.fields(planes), args):
        if not np.array_equal(getattr(planes, f.name), t.cpu().numpy()):
            raise AssertionError(f"full width: {f.name} differs from the "
                                 "planes K1 decoded")
    res["full_width"] = {"series": len(series),
                         "samples": int(planes.counts.sum()),
                         "f2d_ms": (t1 - t0) * 1e3,
                         "pack_ms": (t2 - t1) * 1e3, "n_cap": n_cap}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# ingest: the native columnar write paths.
# ---------------------------------------------------------------------------

class RssPeak:
    """The peak resident set of this process over a block: VmRSS read
    from /proc/self/status every `interval` seconds by a thread (a spike
    shorter than that can be missed); None where /proc has no VmRSS."""

    def __init__(self, interval: float = 0.05):
        import threading
        self.interval = interval
        self.peak_bytes = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss_bytes():
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) * 1024
        except (OSError, ValueError):
            pass
        return None

    def _run(self):
        while True:
            r = self.rss_bytes()
            if r is not None:
                self.peak_bytes = max(self.peak_bytes or 0, r)
            if self._done.wait(self.interval):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        r = self.rss_bytes()
        if r is not None:
            self.peak_bytes = max(self.peak_bytes or 0, r)


def same_columns(what: str, got, want) -> None:
    """Two search_columns results: the same series in the same order (by
    raw name: metric ids are seeded from the clock), the same counts,
    timestamps exactly and values bit for bit."""
    if got.raw_names != want.raw_names:
        raise AssertionError(f"{what}: other series or another row order")
    if not (np.array_equal(got.counts, want.counts) and
            np.array_equal(got.ts, want.ts) and
            np.array_equal(got.vals.view(np.int64),
                           want.vals.view(np.int64))):
        raise AssertionError(f"{what}: columns differ")


def route_bodies(labels, ts, vals) -> dict:
    """The same (S, k) columns as the three bodies of the insert routes,
    each under its own metric name: (path, params, headers, body, name).
    Remote write: one snappy WriteRequest; Prometheus text and Influx
    lines scrape after scrape, values in their shortest round-trip form."""
    out = {}
    named = [{**lb, "__name__": "ingest_rw_total"} for lb in labels]
    out["remote_write"] = ("/api/v1/write", {"Content-Encoding": "snappy"},
                           write_request(named, ts, vals), "ingest_rw_total")
    tv = list(zip(ts.T.tolist(), vals.T.tolist()))
    heads = [f'ingest_prom_total{{instance="{lb["instance"]}",'
             f'id="{lb["id"]}"}} ' for lb in labels]
    out["prometheus"] = ("/api/v1/import/prometheus", {}, "".join(
        f"{h}{v!r} {t}\n" for tr, vr in tv
        for h, t, v in zip(heads, tr, vr)).encode(), "ingest_prom_total")
    heads = [f'ingest_influx,instance={lb["instance"]},id={lb["id"]} total='
             for lb in labels]
    out["influx"] = ("/influx/write", {}, "".join(
        f"{h}{v!r} {t * 1_000_000}\n" for tr, vr in tv
        for h, t, v in zip(heads, tr, vr)).encode(), "ingest_influx_total")
    return out


def ingest_native(bodies: dict, rows: int) -> dict:
    """(a) the native library loads and each of its ingest entry points
    returns the whole batch on the phase's own bodies: a failed g++ build
    fails here, not behind the Python parsers."""
    from victoriametrics_tpu_torch.ingest import snappy
    if not native.available():
        raise AssertionError("ingest: the native library did not build or "
                             "load")
    out = {"library": native.library_path().name,
           "snappy_decoder": "native (ingest.cpp vm_snappy_uncompress)",
           "client_snappy_compress": "libsnappy" if snappy._lib is not None
           else "pure-python"}
    t0 = time.perf_counter()
    raw = native.snappy_uncompress(bodies["remote_write"][2])
    out["snappy_ms"] = (time.perf_counter() - t0) * 1e3
    if raw is None:
        raise AssertionError("ingest: native snappy returned nothing")
    parse = {"remote_write": lambda: native.parse_rw_columnar(raw, 0),
             "prometheus": lambda: native.parse_prom_columnar(
                 bodies["prometheus"][2], 0),
             "influx": lambda: native.parse_influx_columnar(
                 bodies["influx"][2], "", 0)}
    for route, fn in parse.items():
        t0 = time.perf_counter()
        cr = fn()
        ms = (time.perf_counter() - t0) * 1e3
        if cr is None or len(cr) != rows:
            raise AssertionError(f"ingest: the native {route} parser gave "
                                 f"{None if cr is None else len(cr)} rows, "
                                 f"not {rows}")
        out[route] = {"parse_ms": ms, "rows_per_s": rows / ms * 1e3,
                      "body_bytes": len(bodies[route][2])}
    return out


def ingest_routes(stores: Stores, labels, ts, vals) -> dict:
    """(b) the port's vmsingle on a store of its own.  Each route gets
    two bodies of its own metric name: the first scrape of every series
    (`register`: every key is new, so each takes the per-key slow path)
    and then the next INGEST_SCRAPES (`write`: every key known, the
    steady path).  Each must take the native columnar branch (the
    tenant's columnar space gains every series' key with the first body
    and none with the second, nothing dropped, every row counted); the
    server's columns of each route equal those of a store written by
    add_rows with the same rows."""
    from victoriametrics_tpu_torch.apps import vmsingle
    from victoriametrics_tpu_torch.utils import profiler
    S = ts.shape[0]
    first = route_bodies(labels, ts[:, :1], vals[:, :1])
    bodies = route_bodies(labels, ts[:, 1:], vals[:, 1:])
    # it answers no query through the engine: the host backend spares it
    # the card's attach (about 9 s)
    storage, srv, api = vmsingle.build(vmsingle.parse_flags([
        f"-storageDataPath={stores.path('ingest_http')}",
        "-httpListenAddr=127.0.0.1:0", "-search.tpuBackend=false"]))
    srv.start()
    out = {}
    try:
        c = HttpClient(srv.port)
        for route in bodies:
            out[route] = {}
            for part, (path, headers, body, _), new, rows in (
                    ("register", first[route], S, S),
                    ("write", bodies[route], 0, S * (ts.shape[1] - 1))):
                keys0, rows0 = columnar_keys(api.storage), api.rows_inserted
                code, resp, ms = c.post(path, body, headers)
                if code != 204:
                    raise AssertionError(f"ingest {route}: {code} "
                                         f"{resp[:300]}")
                keys = columnar_keys(api.storage) - keys0
                if keys != new or api.rows_inserted - rows0 != rows or \
                        api.columnar_drop_stats:
                    raise AssertionError(
                        f"ingest {route} {part}: not the columnar branch "
                        f"({keys} keys, {api.rows_inserted - rows0} rows, "
                        f"dropped {api.columnar_drop_stats})")
                out[route][part] = {"rows": rows, "body_bytes": len(body),
                                    "write_ms": ms,
                                    "rows_per_s": rows / ms * 1e3,
                                    "columnar_keys_added": keys}
        want = stores.open("ingest_rows")
        for route, (*_, name) in bodies.items():
            t0 = time.perf_counter()
            ingest(want, [{**lb, "__name__": name} for lb in labels], ts,
                   vals)
            out[route]["add_rows_ms"] = (time.perf_counter() - t0) * 1e3
            f = [TagFilter(b"", name.encode())]
            got = api.storage.search_columns(f, T_START - DAY, T_START + DAY,
                                             tenant=TENANT)
            if len(got.raw_names) != S or int(got.counts.sum()) != ts.size:
                raise AssertionError(f"ingest {route}: the server's store "
                                     f"holds {len(got.raw_names)} series")
            same_columns(f"ingest {route} vs add_rows", got,
                         want.search_columns(f, T_START - DAY,
                                             T_START + DAY, tenant=TENANT))
            out[route]["columns_equal_add_rows"] = True
        stores.close(want)
    finally:
        srv.stop()
        storage.close()
        profiler.PROFILER.stop()
    return out


def full_width_labels(S: int, G: int) -> list[dict]:
    """The full width's series as a scraper labels them: 32 a `instance`
    (series i in group i % G, as the full_width phase groups them)."""
    return [{"__name__": FULL_SELECTOR, "instance": f"fw-{i % G}",
             "id": str(i)} for i in range(S)]


def ingest_full_width(stores: Stores, fw) -> tuple[dict, dict]:
    """(c) the full width's series on the store: the first STORE_HOURS of the
    100,000 counters through Storage.add_rows_columnar, 40 scrapes a call
    (every series kept); closed and reopened, its search_columns must
    equal the in-memory cut (timestamps exactly, values bit for bit).
    Returns the part's record and the columns read back, which the mesh
    phase's part (b) takes."""
    S, G = FULL_SERIES, FULL_SERIES // FULL_PER_GROUP
    n_cut = min(int(STORE_HOURS * 3_600_000 // SCRAPE), fw["N"])
    ts, vals = fw["ts"][:, :n_cut], fw["vals"][:, :n_cut]
    labels = full_width_labels(S, G)
    t0 = time.perf_counter()
    keys = series_keys(labels)
    keys_s = time.perf_counter() - t0
    store = stores.open("full_width")
    calls = []
    with RssPeak() as rss:
        add_s = ingest_columnar(store, keys, ts, vals, calls=calls)
        if columnar_keys(store) != S:
            raise AssertionError("full width store: the columnar space does "
                                 "not hold every series")
        t0 = time.perf_counter()
        stores.close(store)
        close_s = time.perf_counter() - t0
    on_disk = disk_bytes(stores.path("full_width"))
    t0 = time.perf_counter()
    store = stores.open("full_width")
    open_s = time.perf_counter() - t0
    f0 = fetch_s()
    t0 = time.perf_counter()
    cols = store.search_columns([TagFilter(b"", FULL_SELECTOR.encode())],
                                T_START - DAY, T_START + DAY, tenant=TENANT)
    search_s = time.perf_counter() - t0
    fetch_ms = (fetch_s() - f0) * 1e3
    # the in-memory cut in the store's row order, named independently
    raws = [MetricName.from_dict(lb).marshal() for lb in labels]
    order = np.array(sorted(range(S), key=raws.__getitem__), np.int64)
    if cols.raw_names != [raws[i] for i in order]:
        raise AssertionError("full width store: other series or another "
                             "row order")
    if not (np.array_equal(cols.counts, np.full(S, n_cut)) and
            np.array_equal(cols.ts, ts[order]) and
            np.array_equal(cols.vals.view(np.int64),
                           vals[order].view(np.int64))):
        raise AssertionError("full width store: columns differ from the "
                             "in-memory cut")
    stores.close(store)
    n_rows = S * n_cut
    rec = {"series": S, "instances": G, "hours": STORE_HOURS,
           "samples_per_series": n_cut, "rows": n_rows,
           "scrapes_per_call": SCRAPES_PER_CALL, "keys_s": keys_s,
           "add_rows_columnar_s": add_s, "rows_per_s": n_rows / add_s,
           # the first call registers every series (the slow path per
           # new key); the others resolve whole batches natively
           "first_call_s": calls[0],
           "steady_rows_per_s": (n_rows - S * min(SCRAPES_PER_CALL, n_cut))
           / max(sum(calls[1:]), 1e-9),
           "close_s": close_s, "disk_bytes": on_disk,
           "bytes_per_sample": on_disk / n_rows,
           "peak_rss_bytes": rss.peak_bytes, "open_s": open_s,
           "search_columns_ms": search_s * 1e3,
           "columns_fetch_ms": fetch_ms, "columns_equal_memory": True,
           # all 24 h through the same path: the first call's
           # registration once, the rest of the writes and the close
           # in proportion
           "all_hours_estimate_s": calls[0] +
           (add_s - calls[0] + close_s) * fw["N"] / n_cut}
    return rec, {"cols": cols, "order": order, "n_cut": n_cut,
                 "hours": STORE_HOURS}


def phase_ingest(rng, stores: Stores, fw) -> tuple[dict, dict]:
    """The ingestion layer: (a) the native library's ingest entry points,
    (b) the three insert routes through the port's vmsingle, (c) the full
    width's series written to a store.  Returns the phase's result and
    the columns part (c) read back."""
    t_phase = time.perf_counter()
    walls = {}
    labels = dash_labels(DASH_SERIES)
    ts, vals = counters(rng, DASH_SERIES, 1 + INGEST_SCRAPES, T_START)
    t0 = time.perf_counter()
    nat = ingest_native(route_bodies(labels, ts[:, 1:], vals[:, 1:]),
                        DASH_SERIES * INGEST_SCRAPES)
    walls["native"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes = ingest_routes(stores, labels, ts, vals)
    walls["routes"] = time.perf_counter() - t0
    print(json.dumps({"cut": {"full_width_store_hours": STORE_HOURS,
                              "planned_hours": 6}}), flush=True)
    t0 = time.perf_counter()
    fw_rec, fw_store = ingest_full_width(stores, fw)
    walls["full_width"] = time.perf_counter() - t0
    res = {"phase": "ingest", "ok": True,
           "wall_s": time.perf_counter() - t_phase, "part_wall_s": walls,
           "native": nat, "routes": routes, "full_width_store": fw_rec}
    emit(res)
    return res, fw_store


class Aside:
    """Launches made beside the mesh path (the unsharded comparisons and
    the cold rebuilds): `with aside():` records them so the path's counts
    leave them out."""

    def __init__(self):
        self.n = collections.Counter()

    @contextlib.contextmanager
    def __call__(self):
        before = dict(kernels.LAUNCHES)
        try:
            yield
        finally:
            for k, v in kernels.LAUNCHES.items():
                self.n[k] += v - before.get(k, 0)


def mesh_dashboard(dev, replay, aside) -> dict:
    """(a): the dashboard's cold query and its first MESH_DASH_REFRESHES
    refreshes through an engine on MESH_SHARDS logical shards, against an
    unsharded engine on the same replayed store (whose sum equals
    phase_dashboard's results bit for bit) and against cold rebuilds.  Returns the part's result and the
    state (d) and (e) continue from."""
    store = replay["store"]
    start, end = dashboard_grid()
    gids, group_keys = instance_groups(store.search_series(
        FILTERS, start - WINDOW - LOOKBACK_DELTA, end, tenant=TENANT))
    G = len(group_keys)
    mesh = meshlib.make_mesh(MESH_SHARDS, 1, [dev] * MESH_SHARDS)
    meng = ce.CUDAEngine(mesh=mesh)
    flat = ce.CUDAEngine(device=dev)

    def cold(eng, start_ms, end_ms, key=None):
        series = store.search_series(FILTERS, start_ms - WINDOW -
                                     LOOKBACK_DELTA, end_ms, tenant=TENANT)
        cfg = RollupConfig(start_ms, end_ms, DASH_STEP, WINDOW)
        return ce.try_aggr_rollup(eng, "sum", "rate", series, gids, G, cfg,
                                  cache_key=key), series

    ver0 = store.data_version
    key = ("mesh-dashboard", start, ver0)
    snap = split_snapshot()
    t0 = time.perf_counter()
    got, series = cold(meng, start, end, key)
    cold_s = time.perf_counter() - t0
    cold_split = split_ms(snap, split_snapshot(), cold_s)
    planes = []
    restore = decode_tap(planes)
    try:
        with aside():
            want, _ = cold(flat, start, end, key)
    finally:
        restore()
    if not np.array_equal(want.view(np.int64), replay["cold"].view(np.int64)):
        raise AssertionError("mesh: the replayed store differs from the "
                             "dashboard phase's")
    cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
    tiles = meng.cache().get(key)
    if len(tiles[0]) != MESH_SHARDS:
        raise AssertionError("mesh: the tile is not sharded")
    worst = {}

    def compare(what, served):
        """Every aggregate on both engines' tiles."""
        mean = None
        for aggr in dr.AGGR_FUNCS:
            g = served(meng, aggr)
            with aside():
                w = served(flat, aggr)
            e = mesh_close(f"mesh {what} {aggr}", aggr, g, w, "rate", mean)
            if aggr == "avg":
                mean = torch.from_numpy(w)
            worst[aggr] = max(worst.get(aggr, 0.0), e)

    compare("cold", lambda eng, aggr: ce.try_aggr_rollup(
        eng, aggr, "rate", series, gids, G, cfg, cache_key=key))
    skey, tkey = dashboard_keys()
    fetch_lo = start - WINDOW - LOOKBACK_DELTA
    for eng in (meng, flat):
        if ce.register_window(eng, skey, tkey, gids, group_keys,
                              tile_key=key, series=series, cfg=cfg,
                              fetch_info=(fetch_lo, end, ver0),
                              structural=store.structural_version) is None:
            raise AssertionError("mesh: the rolling window was not filed")
    refresh_ms, worst_cold, worst_q = [], 0.0, 0.0
    keys = series_keys(replay["labels"])
    for i, ((k, adv), batch) in enumerate(zip(
            DASH_REFRESHES[:MESH_DASH_REFRESHES], replay["batches"])):
        # the replayed batches through the columnar path (the store equal
        # to the dashboard phase's is checked below, refresh by refresh)
        ingest_columnar(store, keys, *batch)
        start, end = start + adv, end + adv
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
        rolled = {}
        for eng in (meng, flat):
            with contextlib.ExitStack() as stack:
                if eng is flat:
                    stack.enter_context(aside())
                t0 = time.perf_counter()
                rt, groups, *_ = eng.window_cache().get(skey)
                if not ce.advance_rolling(eng, rt, store, FILTERS, start,
                                          fetch_lo, end, None, TENANT, True):
                    raise AssertionError("mesh refresh declined: "
                                         + eng.last_roll_decline)
                rolled[eng is meng] = (rt, groups, ce.run_fused_on_tiles(
                    eng, "sum", "rate", rt.tiles, groups, cfg,
                    start - rt.base_ms, fetch_lo - start))
                if eng is meng:
                    refresh_ms.append((time.perf_counter() - t0) * 1e3)
        served = rolled[True][2]
        if not np.array_equal(rolled[False][2].view(np.int64),
                              replay["served"][i].view(np.int64)):
            raise AssertionError("mesh: the replayed refresh differs from "
                                 "the dashboard phase's")

        def on_tile(eng, aggr):
            rt, groups, _ = rolled[eng is meng]
            return ce.run_fused_on_tiles(eng, aggr, "rate", rt.tiles, groups,
                                         cfg, start - rt.base_ms,
                                         fetch_lo - start)

        compare(f"refresh {i}", on_tile)
        # the quantile panel: B5 per shard, B8 on the gathered rows
        rt, groups, _ = rolled[True]
        q = ce.run_quantile_on_tiles(meng, 0.9, "rate", rt.tiles, groups,
                                     cfg, start - rt.base_ms,
                                     fetch_lo - start)
        with aside():
            rtf, gf, _ = rolled[False]
            qf = ce.run_quantile_on_tiles(flat, 0.9, "rate", rtf.tiles, gf,
                                          cfg, start - rtf.base_ms,
                                          fetch_lo - start)
            rebuilt, _ = cold(ce.CUDAEngine(mesh=mesh), start, end)
        worst_q = max(worst_q, assert_exact(
            f"mesh quantile refresh {i}", torch.from_numpy(q),
            torch.from_numpy(qf)))
        worst_cold = max(worst_cold, assert_close(
            f"mesh served == cold {i}", served, rebuilt, 1e-12, 0.0))
    rt = meng.window_cache().get(tkey)
    return {"cold_ms": cold_s * 1e3, "cold_split": cold_split,
            "refresh_ms": refresh_ms, "appends": rt.appends,
            "max_abs_err_vs_unsharded": worst,
            "served_vs_cold_max_abs_err": worst_cold,
            "quantile_max_abs_err_vs_unsharded": worst_q}, {
        "mesh": mesh, "engine": meng, "flat": flat, "end": end,
        "store": store, "labels": replay["labels"], "keys": keys,
        "feed": replay["feed"],
        "gids": gids, "group_keys": group_keys, "planes": planes[0],
        "cfg": cfg}


def mesh_fleet(dev, st, aside) -> dict:
    """(d): 16 standing queries (rate x the 8 aggregates x grid B's two
    groupings: 2 buckets of 8) through the mesh engine's fleet (an 8-way
    stream mesh: B14, and B10 / B11 per shard) and through an unsharded
    engine's, on the replayed store, every stream of every interval bit
    for bit."""
    store, meng = st["store"], st["engine"]
    S, G = DASH_SERIES, DASH_GROUPS
    _, tkey = dashboard_keys()
    inst, inst_keys = st["gids"], st["group_keys"]
    start, end = st["end"] - (DASH_SAMPLES - 1) * SCRAPE + 300_000, st["end"]
    flat = ce.CUDAEngine(device=dev)
    with aside():
        series = store.search_series(FILTERS, start - WINDOW -
                                     LOOKBACK_DELTA, end, tenant=TENANT)
        cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
        key = ("mesh-fleet", start)
        ce.try_aggr_rollup(flat, "sum", "rate", series, inst, G, cfg,
                           cache_key=key)
        skey0, _ = ce.device_roll_keys(SELECTOR, TENANT, "rate", "sum",
                                       None, ("instance",), False, None,
                                       WINDOW)
        ce.register_window(flat, skey0, tkey, inst, inst_keys, tile_key=key,
                           series=series, cfg=cfg,
                           fetch_info=(start - WINDOW - LOOKBACK_DELTA, end,
                                       store.data_version),
                           structural=store.structural_version)
    dur, step, groupings = FLEET_GRIDS["B"]
    layouts = ((inst, inst_keys), (np.zeros(S, np.int32), [()]))
    texts = [(fleet_text(aggr, "rate", *gw), aggr, gw, layout)
             for aggr in dr.FLEET_AGGR_CODES
             for gw, layout in zip(groupings, layouts)]
    sides = {m: [StandingQuery(q, step, dur) for q, *_ in texts]
             for m in (True, False)}
    apis = {m: FleetAPI(store, meng if m else flat, sides[m])
            for m in (True, False)}
    planes = {True: meng.fleet(), False: flat.fleet()}
    keyed = {True: [], False: []}
    for m, eng in ((True, meng), (False, flat)):
        for sq, (_, aggr, gw, (gids, keys)) in zip(sides[m], texts):
            skey = standing_info(planes[m], apis[m], sq, "rate", aggr,
                                 *gw)["skey"]
            if ce.register_window(eng, skey, tkey, gids, keys) is None:
                raise AssertionError("mesh fleet: window not filed")
            keyed[m].append((sq, skey))
    now = -(-(end + MESH_FLEET_INTERVALS[0][1]) // 60_000) * 60_000
    wall_ms, launches = [], []
    for i, (k, adv) in enumerate(MESH_FLEET_INTERVALS):
        if i:
            now += adv
        ingest_columnar(store, st["keys"],
                        *st["feed"].next(k, now - adv))
        before = kernels.LAUNCHES.get("cached_fleet_rollup_aggregate", 0)
        t0 = time.perf_counter()
        n = planes[True].run(apis[True], now)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(kernels.LAUNCHES.get(
            "cached_fleet_rollup_aggregate", 0) - before)
        with aside():
            nf = planes[False].run(apis[False], now)
        stats = planes[True].stats()
        # (two buckets at 256 groups; one of 16 when the groupings' group
        # counts share a ladder rung)
        if n != nf or n != stats["buckets"] or launches[-1] != n or \
                stats["members"] != 16 or stats["evictions"]:
            raise AssertionError(f"mesh fleet interval {i}: {n}/{nf} "
                                 f"launches, {stats}, "
                                 f"{planes[True].last_decline}")
        for b in planes[True]._buckets.values():
            if b.B_pad % MESH_SHARDS or len(b.dev["ts"]) != MESH_SHARDS:
                raise AssertionError("mesh fleet: a bucket is not stream-"
                                     "sharded")
        for (qm, skey), (qf, _) in zip(keyed[True], keyed[False]):
            rm, rf = planes[True]._results[skey], planes[False]._results[skey]
            if rm.end != now or not np.array_equal(
                    rm.rows.view(np.int64), rf.rows.view(np.int64)):
                raise AssertionError(f"mesh fleet interval {i} {qm.q}: "
                                     "differs from the unsharded fleet")
            if not np.isfinite(rm.rows).any():
                raise AssertionError(f"mesh fleet {qm.q}: no finite value")
            qm.end = qf.end = now
    return {"streams": 16, "buckets": len(planes[True]._buckets),
            "interval_ms": wall_ms, "b14_launches": launches,
            "bitwise_vs_unsharded": True}


def mesh_decode(dev, what, planes, cfg, aside, tiles=None,
                chunk=4096) -> dict:
    """(e): B12 on an engine's delta planes against K1 -> B5 (K1 run
    again, or the engine's decoded `tiles` where no append has touched
    them) bit for bit, and against its plain version on the first,
    middle and last row chunks (K1 and B5 are each held against theirs
    over every row elsewhere)."""
    args, n_cap = planes[:8], planes[8]
    ncfg = dr.normalized_cfg("rate", cfg)
    got = dd.decode_and_rollup("rate", *args, ncfg, n_cap)
    with aside():
        if tiles is None:
            tiles = (*dd.decode_tiles(*args, n_cap), args[7])
        want = dr.rollup_tile("rate", *tiles, ncfg)
    assert_equal(f"B12 {what} vs K1 -> B5", got, want)
    del want
    err = 0.0
    S = int(args[7].shape[0])
    for r0 in sorted({0, S // 2 // chunk * chunk, (S - 1) // chunk * chunk}):
        err = max(err, func_close(
            f"B12 {what} rows {r0}+", "rate", got[r0:r0 + chunk],
            dd.decode_and_rollup_plain(
                "rate", *(a[r0:r0 + chunk] for a in args), ncfg, n_cap)))
    del got
    b12 = lambda: dd.decode_and_rollup("rate", *args, ncfg,  # noqa: E731
                                       n_cap)
    k1_b5 = lambda: dr.rollup_tile(  # noqa: E731
        "rate", *dd.decode_tiles(*args, n_cap), args[7], ncfg)
    with aside():
        ms = cuda_ms(b12, reps=3)
        k1_b5_ms = cuda_ms(k1_b5, reps=3)
        dev_ms = device_ms(b12, 5)
        k1_b5_dev_ms = device_ms(k1_b5, 5)
    return {"max_abs_err_vs_plain": err, "rows": S, "cols": int(n_cap),
            "steps": dr.num_steps(ncfg), "ms": ms, "k1_then_b5_ms": k1_b5_ms,
            "device_ms": dev_ms, "k1_then_b5_device_ms": k1_b5_dev_ms}


def mesh_full_width(dev, fw, fw_store, aside) -> tuple[dict, dict]:
    """(b) the full-width cold query over the hours the ingest phase wrote
    to its store (STORE_HOURS, every series kept), its series the
    columns read back from that store in the store's row order, grouped
    by their instance, through the sharded engine, against K2 on the same
    cut tile unsharded (the shards' row blocks side by side), in every
    aggregate; and (c) B15 on a (2, 4) mesh over the full-width tile's
    columns against B5."""
    S, G = FULL_SERIES, FULL_SERIES // FULL_PER_GROUP
    flat, key = fw["engine"], fw["key"]
    cols, n_cut = fw_store["cols"], fw_store["n_cut"]
    # row r of the store is series order[r], of instance fw-<order[r] % G>
    gids = (fw_store["order"] % G).astype(np.int32)
    cut = [SeriesData(None, cols.ts[r, :n_cut], cols.vals[r, :n_cut],
                      raw_name=cols.raw_names[r]) for r in range(S)]
    cfg = RollupConfig(T_START, T_START + n_cut * SCRAPE, FULL_STEP, WINDOW)
    key_cut = ("mesh_full_width_cut",)
    mesh = meshlib.make_mesh(MESH_SHARDS, 1, [dev] * MESH_SHARDS)
    meng = ce.CUDAEngine(mesh=mesh, cache_bytes=64 << 30)
    snap = split_snapshot()
    t0 = time.perf_counter()
    out = ce.try_aggr_rollup(meng, "sum", "rate", cut, gids, G, cfg,
                             cache_key=key_cut)
    total = time.perf_counter() - t0
    split = split_ms(snap, split_snapshot(), total)
    ts_s, v_s, c_s = meng.cache().get(key_cut)
    # the unsharded tile: the shards' row blocks in order (padded rows,
    # count 0, in group 0 add nothing)
    unsharded = ce.CUDAEngine(device=dev)
    tile = tuple(torch.cat(list(x)) for x in (ts_s, v_s, c_s))
    gids_pad = np.zeros(tile[0].shape[0], np.int32)
    gids_pad[:S] = gids
    groups1 = ce.groups_for(unsharded, gids_pad, G)
    with aside():
        want = ce.run_fused_on_tiles(unsharded, "sum", "rate", tile, groups1,
                                     cfg)
    aggr_close("mesh full width sum", "sum", torch.from_numpy(out),
               torch.from_numpy(want))
    worst = {}
    mean = None
    for aggr in dr.AGGR_FUNCS:
        g = ce.try_aggr_rollup(meng, aggr, "rate", cut, gids, G, cfg,
                               cache_key=key_cut)
        with aside():
            w = ce.run_fused_on_tiles(unsharded, aggr, "rate", tile, groups1,
                                      cfg)
        worst[aggr] = mesh_close(f"mesh full width {aggr}", aggr, g, w,
                                 "rate", mean)
        if aggr == "avg":
            mean = torch.from_numpy(w)
    del tile, groups1, unsharded
    groups = ce.groups_for(meng, gids, G)
    ncfg = dr.normalized_cfg("rate", cfg)
    fn = meshlib.cached_sharded_rollup_aggregate(mesh, "rate", "sum", ncfg,
                                                 G)
    with aside():
        b13_ms = cuda_ms(lambda: fn(ts_s, v_s, c_s, groups.shards), reps=3)
    del ts_s, v_s, c_s, groups, meng, cut
    b = {"hours": fw_store["hours"], "samples_per_series": n_cut,
         "series_from": "the ingest phase's store",
         "total_ms": total * 1e3, "split": split, "b13_event_ms": b13_ms,
         "max_abs_err_vs_unsharded": worst}
    # (c) B15 over the tile's first N columns (every sample valid)
    ts_t, v_t, counts = flat.cache().get(key)
    if not bool((counts == fw["N"]).all()):
        raise AssertionError("full width: rows of unequal length")
    # columns in 4 chunks whose grids line up with B15_STEP: N % 16 == 0
    N = fw["N"] // 16 * 16
    mesh15 = meshlib.make_mesh(*B15_MESH, [dev] * MESH_SHARDS)
    valid = torch.ones((S, N), dtype=torch.bool, device=dev)
    parts = [meshlib.split_2d(mesh15, x)
             for x in (ts_t[:, :N], v_t[:, :N], valid)]
    cfg15 = RollupConfig(0, N * SCRAPE - B15_STEP, B15_STEP, WINDOW)
    c = {}
    for func in ("rate", "timestamp"):
        step = meshlib.time_sharded_rollup(mesh15, func, cfg15, B15_HALO)
        got = step(*parts)
        with aside():
            want = dr.rollup_tile(func, ts_t, v_t, counts, cfg15)
        if not bool(torch.isfinite(got[:, WINDOW // B15_STEP + 1:]).all()):
            raise AssertionError(f"full width B15 {func}: not finite")
        c[func] = {"max_abs_err_vs_b5": assert_close(
            f"full width B15 {func}", got, want, 1e-9, 1e-9),
            "calls": check_b15_phases(f"full width B15 {func}", func, step,
                                      parts, 1)}
        del got, want
    step = meshlib.time_sharded_rollup(mesh15, "rate", cfg15, B15_HALO)
    with aside():
        c["rate"]["ms"] = cuda_ms(lambda: step(*parts), reps=3)
        c["rate"]["device_ms"] = device_ms(lambda: step(*parts), 5)
        c["rate"]["b5_ms"] = cuda_ms(lambda: dr.rollup_tile(
            "rate", ts_t, v_t, counts, cfg15), reps=3)
    c.update(mesh=list(B15_MESH), halo=B15_HALO, step=B15_STEP,
             steps=dr.num_steps(cfg15), cols=N)
    return b, c


def phase_mesh(dev, replay, fw, fw_store) -> dict:
    """The mesh phase, (a)-(e), every shard on `dev`.  Its launch counts
    leave out the unsharded comparisons and the cold rebuilds."""
    t_phase = time.perf_counter()
    print(json.dumps({"cut": {
        "mesh_dashboard_refreshes": MESH_DASH_REFRESHES,
        "planned_refreshes": len(DASH_REFRESHES),
        "mesh_fleet_intervals": len(MESH_FLEET_INTERVALS),
        "planned_intervals": MESH_FLEET_PLANNED}}), flush=True)
    aside = Aside()
    kernels.reset_launches()
    walls = {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[name] = time.perf_counter() - t0

    dash, st = part("dashboard", mesh_dashboard, dev, replay, aside)
    fl = part("fleet", mesh_fleet, dev, st, aside)
    e = {"dashboard": part("decode_dashboard", mesh_decode, dev, "dashboard",
                           st["planes"], st["cfg"], aside)}
    del st
    b, c = part("full_width", mesh_full_width, dev, fw, fw_store, aside)
    e["full_width"] = part(
        "decode_full_width", mesh_decode, dev, "full width",
        fw["planes"][0] + (fw["planes"][1],), fw["cfg"], aside,
        fw["engine"].cache().get(fw["key"]))
    launches = {k: kernels.LAUNCHES.get(k, 0) - aside.n.get(k, 0)
                for k in SOURCES}
    for name in MESH_KERNELS + ("decode_tiles", "append_tile",
                                "compact_tile", "fleet_append_tile",
                                "fleet_compact_tile"):
        if launches[name] < 1:
            raise AssertionError(f"mesh: {name} not launched on the path")
    res = {"phase": "mesh", "ok": True, "shards": MESH_SHARDS,
           "wall_s": time.perf_counter() - t_phase, "part_wall_s": walls,
           "dashboard": dash,
           "fleet": fl, "full_width": b, "time_sharded": c,
           "decode_and_rollup": e, "launches": launches}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The cluster: vmstorage x 3, vminsert and vmselect over the reference's RPC.
# ---------------------------------------------------------------------------

class StorageNodeProc:
    """One ``python -m victoriametrics_tpu_torch.apps.vmstorage`` process on
    127.0.0.1 with its own data directory and ports (read from its start
    line); it never touches the card."""

    _STARTED = re.compile(rb"vmstorage started: data=.* insert=(\d+) "
                          rb"select=(\d+) http=(\d+)")

    def __init__(self, root: str, i: int):
        self.name = f"vmstorage-{i}"
        self.path = os.path.join(root, self.name)
        self.log_path = self.path + ".log"
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "victoriametrics_tpu_torch.apps."
                 "vmstorage", f"-storageDataPath={self.path}",
                 "-vminsertAddr=127.0.0.1:0", "-vmselectAddr=127.0.0.1:0",
                 "-httpListenAddr=127.0.0.1:0"],
                stdout=log, stderr=subprocess.STDOUT, env=app_env(),
                cwd=os.path.dirname(os.path.abspath(__file__)))
        self.ports = None

    def log(self) -> bytes:
        with open(self.log_path, "rb") as f:
            return f.read()

    def wait_started(self, timeout: float) -> None:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            hit = self._STARTED.search(self.log())
            if hit:
                self.ports = tuple(int(x) for x in hit.groups())
                return
            if self.proc.poll() is not None:
                break
            time.sleep(0.1)
        raise AssertionError(f"{self.name} did not start (exit "
                             f"{self.proc.poll()}): {self.log()[-2000:]!r}")

    @property
    def spec(self) -> str:
        return f"127.0.0.1:{self.ports[0]}:{self.ports[1]}"

    def get(self, path: str) -> bytes:
        code, body, _ = HttpClient(self.ports[2]).get(path)
        if code != 200:
            raise AssertionError(f"{self.name} {path}: {code} {body[:300]}")
        return body

    def stop(self, sig: int, timeout: float = 300) -> int:
        self.proc.send_signal(sig)
        return self.proc.wait(timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def cluster_hour(fw) -> dict:
    """The first CLUSTER_HOURS of the full width's series (copies: the
    full width's 24 h are freed before the cluster phase)."""
    n = min(int(CLUSTER_HOURS * 3_600_000 // SCRAPE), fw["N"])
    S = fw["ts"].shape[0]
    return {"labels": full_width_labels(S, S // FULL_PER_GROUP),
            "ts": fw["ts"][:, :n].copy(), "vals": fw["vals"][:, :n].copy()}


def cluster_write(cluster, hour) -> dict:
    """The hour through vminsert's ClusterStorage.add_rows_columnar from
    CLUSTER_AGENTS concurrent writers, each owning the instances
    i % CLUSTER_AGENTS == k, SCRAPES_PER_CALL whole scrapes a call (one
    native.ColumnarRows over its series' raw keys): the first round
    registers every series on its two nodes."""
    from concurrent.futures import ThreadPoolExecutor
    labels, ts, vals = hour["labels"], hour["ts"], hour["vals"]
    S, N = ts.shape
    G = S // FULL_PER_GROUP
    agents = []
    for k in range(CLUSTER_AGENTS):
        idx = np.flatnonzero(np.arange(S) % G % CLUSTER_AGENTS == k)
        agents.append((series_keys([labels[i] for i in idx]), ts[idx],
                       vals[idx]))

    def call(agent, j0):
        (keybuf, offs, lens), t, v = agent
        n = min(SCRAPES_PER_CALL, N - j0)
        cr = native.ColumnarRows(
            keybuf, np.tile(offs, n), np.tile(lens, n),
            np.ascontiguousarray(t[:, j0:j0 + n].T).ravel(),
            np.ascontiguousarray(v[:, j0:j0 + n].T).ravel())
        if cluster.add_rows_columnar(cr, tenant=TENANT) != len(cr):
            raise AssertionError("cluster: vminsert dropped rows")
        return len(cr)

    sent0, rounds = cluster.rows_sent, []
    with ThreadPoolExecutor(CLUSTER_AGENTS) as pool:
        for j0 in range(0, N, SCRAPES_PER_CALL):
            t0 = time.perf_counter()
            rows = sum(pool.map(lambda a: call(a, j0), agents))
            rounds.append((rows, time.perf_counter() - t0))
    n_rows = S * N
    if cluster.rows_sent - sent0 != CLUSTER_RF * n_rows or cluster.reroutes:
        raise AssertionError(f"cluster: {cluster.rows_sent - sent0} row "
                             f"writes for {n_rows} rows at RF "
                             f"{CLUSTER_RF}, {cluster.reroutes} reroutes")
    later = rounds[1:]
    return {"rows": n_rows, "row_writes": CLUSTER_RF * n_rows,
            "agents": CLUSTER_AGENTS, "scrapes_per_call": SCRAPES_PER_CALL,
            "rounds": len(rounds), "registering_round_s": rounds[0][1],
            "later_rows_per_s": sum(r for r, _ in later) /
            max(sum(t for _, t in later), 1e-9),
            "add_s": sum(t for _, t in rounds),
            "rows_per_s": n_rows / sum(t for _, t in rounds)}


def cluster_nodes_rf(nodes, procs, labels, lo: int, hi: int) -> dict:
    """Every series on exactly CLUSTER_RF nodes, read from the nodes
    themselves (seriesCount_v1 and searchMetricNames_v1 on each); each
    node's rows (its /metrics after the flush) and bytes on disk."""
    want = {MetricName.from_dict(lb).marshal() for lb in labels}
    held = collections.Counter()
    per_node = []
    filters = [TagFilter(b"", FULL_SELECTOR.encode())]
    for n, p in zip(nodes, procs):
        names = {mn.marshal() for mn in
                 n.search_metric_names(filters, lo, hi, TENANT)}
        count = n.series_count(TENANT)
        if count != len(names):
            raise AssertionError(f"cluster {p.name}: series_count {count}, "
                                 f"{len(names)} names")
        held.update(names)
        m = metric_sums(p.get("/metrics").decode(),
                        ("vm_rows ", "vm_timeseries_total "))
        per_node.append({"node": p.name, "series": count,
                         "rows": int(m["vm_rows "]),
                         "timeseries_total": int(m["vm_timeseries_total "]),
                         "disk_bytes": disk_bytes(p.path)})
    if set(held) != want or set(held.values()) != {CLUSTER_RF}:
        raise AssertionError(
            f"cluster: series held {collections.Counter(held.values())} "
            f"times, {len(set(held) ^ want)} names off")
    return {"series_each_on": CLUSTER_RF, "nodes": per_node}


def cluster_request(c, q: str, start: int, end: int, step: int, **kw):
    """One query_range through vmselect: (body, round trip ms, launches,
    the engine's split of the request, the server's cost split)."""
    snap, before = split_snapshot(), dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    body, ms = c.json("/api/v1/query_range", query=q, start=start / 1e3,
                      end=end / 1e3, step=step / 1e3, **kw)
    split = split_ms(snap, split_snapshot(), time.perf_counter() - t0)
    return (body, ms, launched_since(before), split,
            c.server_cost(q, start, end))


def cluster_route(what: str, launches: dict, cold: bool) -> str:
    """The fused route over the fetched columns: K1 + K2 when they are new
    to the card (`cold` requires it), else K2 on the tile that holds them
    (a ClusterStorage has no data_version, so the engine keys its tiles by
    the fetched content's fingerprint: a query over columns equal to an
    earlier query's decodes nothing).  Never K3."""
    if launches.get("rollup_aggregate_tile", 0) < 1 or launches.get(
            "append_tile") or (cold and not launches.get("decode_tiles")):
        raise AssertionError(f"{what}: launched {launches}, not "
                             f"{'K1 + K2' if cold else 'K2'}")
    return "K1 + K2" if launches.get("decode_tiles") else \
        "K2 on the resident tile (content fingerprint hit)"


def not_partial(what: str, body: dict) -> None:
    if body.get("isPartial"):
        raise AssertionError(f"{what}: isPartial")


CLUSTER_SUM = f"sum by (instance)(rate({FULL_SELECTOR}[5m]))"
#: the aggregates of the cold queries through vmselect: min and max (8-11
#: s a round trip) are a depth cut (a "cut" line) made when the
#: satellites phase came
CLUSTER_AGGRS = ("sum", "count")
CLUSTER_PLANNED_AGGRS = ("sum", "count", "min", "max")
#: the cluster phase's Graphite render: one instance's series summed
CLUSTER_RENDER = (f"sumSeries(seriesByTag('name={FULL_SELECTOR}',"
                  "'instance=fw-7'))")


def cluster_queries(c, api, single, dev, grid, aside) -> tuple[dict, dict]:
    """(1) the cold sum through vmselect against the single-node store on
    the card and vmselect's host evaluator at rtol 1e-12; the other
    CLUSTER_AGGRS by instance against the single-node store bit for bit.
    Returns the records and the sum's answer."""
    start, end, step = grid
    grid_s = np.arange(start, end + 1, step) / 1e3
    engine = ce.CUDAEngine(device=dev)
    out = {}
    for aggr in CLUSTER_AGGRS:
        q = CLUSTER_SUM.replace("sum", aggr, 1)
        body, ms, launches, split, cost = cluster_request(c, q, start, end,
                                                          step)
        not_partial(f"cluster cold {aggr}", body)
        got = body_result(body)
        t0 = time.perf_counter()
        with aside():
            rows = exec_query(EvalConfig(
                start=start, end=end, step=step, storage=single,
                lookback_delta=LOOKBACK_DELTA, max_series=MAX_SERIES,
                tpu=engine, disable_cache=True), q)
        single_ms = (time.perf_counter() - t0) * 1e3
        rec = {"round_trip_ms": ms, "body_bytes": c.last["body_bytes"],
               "route": cluster_route(f"cluster cold {aggr}", launches,
                                   aggr == "sum"),
               "launches": launches, "split": split, "cost": cost,
               "single_store_card_ms": single_ms}
        if aggr == "sum":
            rec["vs_single_store_max_abs_err"] = keyed_close(
                "cluster sum vs the single-node store", got,
                served_result(rows, grid_s), 1e-12, 0.0)
            ec = api._ec(start, end, step)
            ec.tpu, ec.disable_cache = None, True
            t0 = time.perf_counter()
            host = exec_query(ec, q)
            rec["host_ms"] = (time.perf_counter() - t0) * 1e3
            rec["vs_host_max_abs_err"] = keyed_close(
                "cluster sum vs vmselect's host evaluator", got,
                served_result(host, grid_s), 1e-12, 0.0)
            rec["groups"] = len(got)
            answer = got
        else:
            same_strings(f"cluster {aggr} vs the single-node store", got,
                         served_result(rows, grid_s))
            rec["vs_single_store"] = "bitwise"
        out[aggr] = rec
    engine.cache().invalidate()
    return out, answer


def cluster_refresh(c, api, grid, cold) -> tuple[dict, dict]:
    """(2) the sum with its end advanced one step after the scrape written
    over HTTP, on the reference's route over a cluster: a ClusterStorage
    has no data_version, so the cold query filed no rolling window and the
    server answers from the rollup result cache, computing only the new
    step from a fresh fetch of its window (K1 + K2 on that tail, no K3).
    Its earlier steps must be the cold answer's, as strings; the whole is
    held against a full evaluation with one node down (phase_cluster)."""
    start, end, step = grid
    body, ms, launches, split, cost = cluster_request(
        c, CLUSTER_SUM, start, end, step, trace="1")
    not_partial("cluster refresh", body)
    route = cluster_route("cluster refresh", launches, True)
    msgs = trace_messages(body["trace"])
    hit = [m for m in msgs if m.startswith("rollup cache: partial hit")]
    fetched = [m for m in msgs if m.startswith("fetch ")]
    if len(hit) != 1 or len(fetched) != 1 or any(
            m.startswith(("device window resident", "not advanceable"))
            for m in msgs):
        raise AssertionError(f"cluster refresh: not the result cache's "
                             f"tail: {msgs}")
    got = body_result(body)
    same_strings("cluster refresh's earlier steps vs the cold answer",
                 {k: [p for p in v if float(p[0]) * 1e3 < end]
                  for k, v in got.items()}, cold)
    if not all(float(v[-1][0]) * 1e3 == end for v in got.values()):
        raise AssertionError("cluster refresh: no value at the new step")
    return {"round_trip_ms": ms, "route": route, "launches": launches,
            "server_route": hit[0], "tail_fetch": fetched[0],
            "engine_roll_decline": api.tpu.last_roll_decline,
            "split": split, "cost": cost,
            "earlier_steps_vs_cold": "bitwise"}, got


def cluster_render(c, single, ts) -> dict:
    """Graphite's /render through vmselect (GraphiteAPI over the
    ClusterStorage): one instance's series summed over the cluster's hour
    at the default 60 s step, ending before the scrape written over HTTP,
    equal as strings to the same request to the single-node store (its
    own GraphiteAPI on a listener of this process)."""
    from victoriametrics_tpu_torch.httpapi.graphite_api import GraphiteAPI
    from victoriametrics_tpu_torch.httpapi.server import HTTPServer
    until = (int(ts.max()) // 60_000) * 60_000 - 60_000
    params = {"target": CLUSTER_RENDER, "from": str(T_START // 1000),
              "until": str(until // 1000)}
    srv = HTTPServer("127.0.0.1", 0)
    GraphiteAPI(single).register(srv)
    srv.start()
    try:
        code, got, ms = c.get("/render", **params)
        code1, want, single_ms = HttpClient(srv.port).get("/render",
                                                          **params)
    finally:
        srv.stop()
    if code != 200 or code1 != 200 or got != want:
        raise AssertionError(f"cluster render: {code} {got[:200]} vs "
                             f"{code1} {want[:200]}")
    (body,) = json.loads(got)
    points = [p for p in body["datapoints"] if p[0] is not None]
    if len(points) < 50:
        raise AssertionError(f"cluster render: {len(points)} points")
    return {"target": CLUSTER_RENDER, "round_trip_ms": ms,
            "single_store_ms": single_ms, "body_bytes": len(got),
            "points": len(points), "vs_single_store": "same bytes"}


def phase_cluster(dev, hour, stores: Stores) -> dict:
    """The port's cluster: three vmstorage processes, vminsert at RF 2
    and vmselect with -search.tpuBackend in this process.  The hour goes
    in through vminsert's ClusterStorage, one more scrape through its
    /api/v1/write; each node's share is checked; the queries go through
    vmselect over HTTP, then with one node killed and with two down.  Its
    launch counts leave out the single-node store's comparisons."""
    from victoriametrics_tpu_torch.apps import vminsert, vmselect
    from victoriametrics_tpu_torch.parallel import rpc
    from victoriametrics_tpu_torch.utils import profiler
    t_phase = time.perf_counter()
    labels, ts, vals = hour["labels"], hour["ts"], hour["vals"]
    S, N = ts.shape
    print(json.dumps({"cut": {"cluster_hours": CLUSTER_HOURS,
                              "store_hours": STORE_HOURS,
                              "planned_hours": 6}}), flush=True)
    print(json.dumps({"cut": {"cluster_aggrs": CLUSTER_AGGRS,
                              "planned_aggrs": CLUSTER_PLANNED_AGGRS}}),
          flush=True)
    aside = Aside()
    rrc.GLOBAL.reset()
    slow0 = os.environ.get("VM_SLOW_QUERY_MS")
    os.environ["VM_SLOW_QUERY_MS"] = "0.001"
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    procs, servers, clusters, walls = [], [], [], {}
    single = None

    def done(part: str, t0: float, rec=None) -> None:
        """A part's wall, printed with its record as the phase goes (a
        part that fails later leaves the earlier ones in the output)."""
        walls[part] = time.perf_counter() - t0
        print(json.dumps({"cluster_part": part, "wall_s": walls[part],
                          "record": rec}), flush=True)

    try:
        t0 = time.perf_counter()
        procs = [StorageNodeProc(root, i) for i in range(CLUSTER_NODES)]
        for p in procs:
            p.wait_started(CLUSTER_START_S)
        done("start_nodes", t0)
        specs = [f"-storageNode={p.spec}" for p in procs]
        ins, ins_srv, ins_api, _ = vminsert.build(vminsert.parse_flags(
            specs + [f"-replicationFactor={CLUSTER_RF}",
                     "-httpListenAddr=127.0.0.1:0", *CLUSTER_FLAGS]))
        ins_srv.start()
        clusters.append(ins)
        servers.append(ins_srv)
        t0 = time.perf_counter()
        sel_flags = specs + [f"-replicationFactor={CLUSTER_RF}",
                             "-httpListenAddr=127.0.0.1:0", *CLUSTER_FLAGS,
                             *CLUSTER_SELECT_FLAGS]
        # vmselect starts as a user starts it (the card by default); its
        # build waits for the attach (probe, engine, warm-up), so it runs
        # on a thread while the hour goes in
        built = {}

        def build_select():
            try:
                built["sel"] = vmselect.build(vmselect.parse_flags(
                    sel_flags))
                built["s"] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 - raised below
                built["error"] = e
        builder = threading.Thread(target=build_select,
                                   name="vmselect-build")
        builder.start()
        t1 = time.perf_counter()
        try:
            write = cluster_write(ins, hour)
        finally:
            builder.join(HTTP_ATTACH_S)
        done("write", t1)
        if "sel" not in built:
            raise AssertionError(f"cluster: vmselect did not start: "
                                 f"{built.get('error')!r}")
        sel, sel_srv, api, _ = built["sel"]
        sel_srv.start()
        clusters.append(sel)
        servers.append(sel_srv)
        attach_s = built["s"]
        if not isinstance(api.tpu, ce.CUDAEngine):
            raise AssertionError("cluster: vmselect's default backend "
                                 f"attached {api.tpu!r}")
        ci, cs = HttpClient(ins_srv.port), HttpClient(sel_srv.port)
        # one more scrape, over vminsert's remote-write route, 7.5 s after
        # the hour's last
        t_scrape = time.perf_counter()
        feed = Feed(CLUSTER_FEED_SEED, vals[:, -1])
        t_last = T_START + (N - 1) * SCRAPE
        ts1, vals1 = feed.next(1, t_last)
        t0 = time.perf_counter()
        body = write_request(labels, ts1, vals1)
        build_ms = (time.perf_counter() - t0) * 1e3
        sent0 = ins.rows_sent
        code, resp, write_ms = ci.post("/api/v1/write", body,
                                       {"Content-Encoding": "snappy"})
        if code != 204 or ins.rows_sent - sent0 != CLUSTER_RF * S or \
                ins.reroutes or ins_api.columnar_drop_stats:
            raise AssertionError(f"cluster remote write: {code} "
                                 f"{resp[:300]}, {ins.rows_sent - sent0} "
                                 f"row writes, {ins.reroutes} reroutes")
        write["http_scrape"] = {"rows": S, "body_bytes": len(body),
                                "build_ms": build_ms, "write_ms": write_ms,
                                "rows_per_s": S / write_ms * 1e3}
        # the nodes' close: each flushes its in-memory rows to parts
        t0 = time.perf_counter()
        flush = {}

        def flush_one(p):
            t = time.perf_counter()
            p.get("/internal/force_flush")
            flush[p.name] = time.perf_counter() - t
        threads = [threading.Thread(target=flush_one, args=(p,))
                   for p in procs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        write["flush_s"] = {**flush, "all": time.perf_counter() - t0}
        done("scrape_and_flush", t_scrape, write)
        t0 = time.perf_counter()
        rf = cluster_nodes_rf(sel.nodes, procs, labels, T_START - DAY,
                              T_START + DAY)
        rf["check_s"] = time.perf_counter() - t0
        done("placement", t0, rf)
        # the queries
        kernels.reset_launches()
        # the grid on the step's phase (the server aligns it so), ending
        # before the ingest phase's store's second hour, if it has one
        step = FULL_STEP
        start = T_START - T_START % step
        end = T_START + N * SCRAPE - SCRAPE
        end -= end % step
        single = stores.open("full_width")
        t0 = time.perf_counter()
        cold, cold_sum = cluster_queries(cs, api, single, dev,
                                         (start, end, step), aside)
        done("cold", t0, cold)
        t0 = time.perf_counter()
        refresh, served = cluster_refresh(cs, api, (start, end + step, step),
                                          cold_sum)
        done("refresh", t0, refresh)
        t0 = time.perf_counter()
        render = cluster_render(cs, single, ts)
        done("graphite_render", t0, render)
        # (3) one node killed: RF 2 covers it, the answer is whole
        procs[0].kill()
        t0 = time.perf_counter()
        body, ms, launches, split, cost = cluster_request(
            cs, CLUSTER_SUM, start, end + step, step, nocache="1")
        not_partial("cluster with one node killed", body)
        got = body_result(body)
        one_down = {
            "killed": procs[0].name, "round_trip_ms": ms,
            "route": cluster_route("cluster one node killed", launches,
                                   False),
            "launches": launches, "split": split, "cost": cost,
            "vs_refresh_max_abs_err": keyed_close(
                "cluster one node killed vs the refresh", got, served,
                1e-12, 0.0)}
        try:
            same_strings("cluster one node killed vs the refresh", got,
                         served)
            one_down["vs_refresh"] = "bitwise"
        except AssertionError:
            one_down["vs_refresh"] = "within rtol 1e-12"
        done("one_down", t0, one_down)
        # (4) two down: one instance's series, partial; denied on a
        # vmselect built with -search.denyPartialResponse
        rc = procs[1].stop(signal.SIGTERM)
        q1 = f'rate({FULL_SELECTOR}{{instance="fw-7"}}[5m])'
        body, ms = cs.json("/api/v1/query_range", query=q1,
                           start=start / 1e3, end=(end + step) / 1e3,
                           step=step / 1e3)
        if body.get("isPartial") is not True:
            raise AssertionError("cluster two down: isPartial is not true")
        # the denial answers no query through the engine: the host
        # backend spares it the card's attach (about 9 s)
        deny, deny_srv, _, _ = vmselect.build(vmselect.parse_flags(
            sel_flags + ["-search.denyPartialResponse",
                         "-search.tpuBackend=false"]))
        deny_srv.start()
        clusters.append(deny)
        servers.append(deny_srv)
        code, resp, deny_ms = HttpClient(deny_srv.port).get(
            "/api/v1/query_range", query=q1, start=start / 1e3,
            end=(end + step) / 1e3, step=step / 1e3)
        err = json.loads(resp)
        if code != 503 or err.get("errorType") != "unavailable":
            raise AssertionError(f"cluster deny partial: {code} {resp[:300]}")
        two_down = {"stopped": procs[1].name, "exit_code": rc,
                    "partial_series": len(body["data"]["result"]),
                    "round_trip_ms": ms, "deny_status": code,
                    "deny_error_type": err["errorType"],
                    "deny_round_trip_ms": deny_ms}
        launches = {k: kernels.LAUNCHES.get(k, 0) - aside.n.get(k, 0)
                    for k in SOURCES}
        # (5) the surviving node's shutdown
        rc = procs[2].stop(signal.SIGTERM)
        if rc != 0 or b"shutdown complete" not in procs[2].log():
            raise AssertionError(f"cluster {procs[2].name}: exit {rc}, "
                                 f"{procs[2].log()[-500:]!r}")
    finally:
        for srv in servers:
            srv.stop()
        for cl in clusters:
            cl.close()
        for p in procs:
            p.kill()
        if single is not None:
            stores.close(single)
        profiler.PROFILER.stop()
        shutil.rmtree(root, ignore_errors=True)
        if slow0 is None:
            os.environ.pop("VM_SLOW_QUERY_MS", None)
        else:
            os.environ["VM_SLOW_QUERY_MS"] = slow0
    res = {"phase": "cluster", "ok": True, "nodes": CLUSTER_NODES,
           "rf": CLUSTER_RF, "series": S, "samples_per_series": N,
           "hours": CLUSTER_HOURS, "frame_codec": rpc.frame_codec(),
           "flags": list(CLUSTER_FLAGS + CLUSTER_SELECT_FLAGS),
           "attach": {**api.attach_timing, "attach_s": attach_s},
           "write": write, "placement": rf, "cold": cold,
           "refresh": refresh, "graphite_render": render,
           "one_down": one_down, "two_down": two_down,
           "shutdown": {"node": procs[2].name, "exit_code": 0},
           "wall_s": time.perf_counter() - t_phase, "part_wall_s": walls,
           "launches": launches}
    emit(res)
    return res


#: the tooling phase's server: 1024 dashboard-shaped counters x 1 h at
#: 15 s written over remote write, then four clients, a writer and a
#: flusher at once for TOOL_ACTIVITY_S under both tracers
TOOL_SERIES, TOOL_SAMPLES, TOOL_SEED = 1024, 240, 23
TOOL_ACTIVITY_S, TOOL_CLIENTS = 10.0, 4
#: the activities run on past TOOL_ACTIVITY_S until K1's, K2's and K3's
#: counters have each moved, at most this long
TOOL_ACTIVITY_MAX_S = 60.0
TOOL_SCRAPE_S, TOOL_FLUSH_S = 0.25, 2.0
#: the sum panel's window, slid to the newest scrape's step
TOOL_WINDOW = 45 * 60_000
TOOL_ENV = {"VMT_LOCKTRACE": "warn", "VMT_RACETRACE": "1"}
TOOL_TRACER_METRICS = ("vm_locktrace_cycles_total",
                       "vm_locktrace_hold_warnings_total",
                       "vm_race_reports_total")
TOOL_KERNELS = {"decode_tiles": HTTP_DEVICE_METRICS[0],
                "rollup_aggregate_tile": HTTP_DEVICE_METRICS[1],
                "append_tile": HTTP_DEVICE_METRICS[2]}


def tool_build_cache() -> dict:
    """(a) ``devtools/compile_cache_smoke`` on the tree the build phase
    built: two cold processes, each loading every kernel library and the
    native one and launching K3 once; neither may start the compiler."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m",
         "victoriametrics_tpu_torch.devtools.compile_cache_smoke"],
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            x for x in (here, os.environ.get("PYTHONPATH")) if x)},
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=900)
    wall = time.perf_counter() - t0
    if p.returncode != 0 or "SKIP" in p.stdout:
        raise AssertionError(f"tooling build cache: exit {p.returncode}: "
                             f"{p.stdout[-3000:]}")
    rep = json.loads(p.stdout.strip().splitlines()[-1])
    children = rep["children"]
    for i, ch in enumerate(children):
        if ch["builds"] or ch["kernel_libs"] != len(kernels.SOURCES) or \
                not ch["native"] or ch["launches"] != 1:
            raise AssertionError(f"tooling build cache: child {i} on the "
                                 f"built tree: {ch}")
    return {"ok": rep["ok"], "children": [
        {"builds": ch["builds"], "kernel_libs": ch["kernel_libs"],
         "native": ch["native"], "launches": ch["launches"],
         "wall_s": ch["wall_s"], "process_s": ch["process_s"]}
        for ch in children], "wall_s": wall}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TracedServer:
    """``python -m victoriametrics_tpu_torch.apps.vmsingle`` with the
    default backend (the card attached) under ``TOOL_ENV``, on a fresh
    data directory; ready once /health answers (after the attach)."""

    def __init__(self, root: str, timeout: float):
        here = os.path.dirname(os.path.abspath(__file__))
        self.path = os.path.join(root, "data")
        self.log_path = os.path.join(root, "vmsingle.log")
        self.port = free_port()
        env = {**os.environ, **TOOL_ENV, "PYTHONPATH": os.pathsep.join(
            x for x in (here, os.environ.get("PYTHONPATH")) if x)}
        t0 = time.perf_counter()
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "victoriametrics_tpu_torch.apps."
                 "vmsingle", f"-storageDataPath={self.path}",
                 f"-httpListenAddr=127.0.0.1:{self.port}"],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here)
        self.c = HttpClient(self.port)
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end and self.proc.poll() is None:
            try:
                if self.c.get("/health")[0] == 200:
                    self.start_s = time.perf_counter() - t0
                    return
            except OSError:
                pass
            time.sleep(0.2)
        self.kill()
        raise AssertionError(f"tooling: vmsingle did not start (exit "
                             f"{self.proc.poll()}): {self.log()[-3000:]!r}")

    def log(self) -> bytes:
        with open(self.log_path, "rb") as f:
            return f.read()

    def metrics(self) -> dict[str, float]:
        code, body, _ = self.c.get("/metrics")
        if code != 200:
            raise AssertionError(f"tooling /metrics: {code}")
        text = body.decode()
        names = (*TOOL_TRACER_METRICS, *TOOL_KERNELS.values())
        missing = [n for n in TOOL_TRACER_METRICS
                   if f"\n{n} " not in "\n" + text]
        if missing:
            raise AssertionError(f"tooling: the server exports no {missing}:"
                                 " the tracers are off")
        return metric_sums(text, names)

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(300)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def tool_host_sum(store: Storage, grid) -> dict:
    """The port's host evaluator on `store`: each series' rate over the
    grid, summed per instance one member after another in the
    evaluator's order (the sum K2 computes), keyed and formatted as the
    server serves it."""
    from victoriametrics_tpu_torch.query.format_value import fmt_value
    start, end, step = grid
    ec = EvalConfig(start=start, end=end, step=step, storage=store,
                    lookback_delta=LOOKBACK_DELTA, tpu=None,
                    disable_cache=True)
    acc = {}
    for r in exec_query(ec, f"rate({SELECTOR}[5m])"):
        k = json.dumps({"instance": r.metric_name.to_dict()["instance"]},
                       sort_keys=True)
        a = acc.setdefault(k, np.full(r.values.size, np.nan))
        live = ~np.isnan(r.values)
        a[live] = np.where(np.isnan(a[live]), r.values[live],
                           a[live] + r.values[live])
    grid_s = np.arange(start, end + 1, step) / 1e3
    return {k: [[float(t), fmt_value(v)] for t, v in zip(grid_s, a)
                if not np.isnan(v)] for k, a in acc.items()}


def tool_activities(c: HttpClient, feed, labels, state, moved) -> dict:
    """TOOL_CLIENTS clients alternating the sum panel with nocache=1 and
    its plain repeat on the window slid to the newest scrape, a writer
    posting one scrape of every series each TOOL_SCRAPE_S and a thread
    calling /internal/force_flush each TOOL_FLUSH_S, together for
    TOOL_ACTIVITY_S and then until moved() (at most TOOL_ACTIVITY_MAX_S).
    Every answer must be whole (200 or 204, not partial); the counts and
    round trips are returned."""
    q = PANEL_TEXTS["sum_by_instance"]
    stop = threading.Event()
    lock = threading.Lock()
    failures, counts = [], collections.Counter()
    trips = collections.defaultdict(list)

    def fail(what: str) -> None:
        with lock:
            failures.append(what)
        stop.set()

    def client(i: int) -> None:
        while not stop.is_set():
            with lock:
                end = state["end"]
            start = end - TOOL_WINDOW
            for kind, extra in (("nocache", {"nocache": "1"}),
                                ("repeat", {})):
                code, body, ms = c.get("/api/v1/query_range", query=q,
                                       start=start / 1e3, end=end / 1e3,
                                       step=DASH_STEP / 1e3, **extra)
                if code != 200:
                    return fail(f"client {i} {kind}: {code} {body[:300]}")
                res = json.loads(body)
                if res.get("isPartial") or \
                        len(res["data"]["result"]) != DASH_GROUPS:
                    return fail(f"client {i} {kind}: partial or "
                                f"{len(res['data']['result'])} series")
                with lock:
                    counts[kind] += 1
                    trips[kind].append(ms)

    def writer() -> None:
        while not stop.wait(TOOL_SCRAPE_S):
            with lock:
                after = state["last"]
            ts, vals = feed.next(1, after)
            body = write_request(labels, ts, vals)
            code, resp, ms = c.post("/api/v1/write", body,
                                    {"Content-Encoding": "snappy"})
            if code != 204:
                return fail(f"writer: {code} {resp[:300]}")
            with lock:
                state["last"] = after + SCRAPE
                state["end"] = state["last"] - state["last"] % DASH_STEP
                counts["scrapes"] += 1
                trips["write"].append(ms)

    def flusher() -> None:
        while not stop.wait(TOOL_FLUSH_S):
            code, resp, ms = c.get("/internal/force_flush")
            if code != 200:
                return fail(f"flusher: {code} {resp[:300]}")
            with lock:
                counts["flushes"] += 1
                trips["flush"].append(ms)

    threads = [threading.Thread(target=client, args=(i,), name=f"client{i}")
               for i in range(TOOL_CLIENTS)]
    threads += [threading.Thread(target=writer, name="writer"),
                threading.Thread(target=flusher, name="flusher")]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    stop.wait(TOOL_ACTIVITY_S)
    while not stop.is_set() and \
            time.perf_counter() - t0 < TOOL_ACTIVITY_MAX_S and not moved():
        stop.wait(1.0)
    stop.set()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "counts": dict(counts), "round_trip_ms": {
        k: {"median": float(np.median(v)), "max": float(np.max(v))}
        for k, v in trips.items()}}
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"tooling: an activity thread is wedged: {rec}")
    if failures:
        raise AssertionError(f"tooling: {failures[:4]}; {rec}")
    if not (counts["nocache"] and counts["repeat"] and counts["scrapes"]
            and counts["flushes"]):
        raise AssertionError(f"tooling: an activity did not run: {rec}")
    return rec


def phase_tooling() -> dict:
    """(a) the build-cache smoke on the built tree; (b) the port's
    vmsingle as a process with the default backend under
    VMT_LOCKTRACE=warn and VMT_RACETRACE=1 on a fresh directory: 1024
    dashboard-shaped counters x 1 h at 15 s over /api/v1/write, then the
    activities (tool_activities); from /metrics no lock-order cycle and
    no race report, and K1's, K2's and K3's device counters moved; the
    sum panel after the writers stop within rtol 1e-12 of the host
    evaluator's one-by-one group sum on the same store (read after the
    server's SIGTERM, exit 0).  A race or a cycle prints the server's
    report (both stacks) and fails the phase."""
    t_phase = time.perf_counter()
    cache = tool_build_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    server = None
    try:
        server = TracedServer(root, HTTP_ATTACH_S)
        c = server.c
        labels = dash_labels(TOOL_SERIES)
        rng = np.random.default_rng(TOOL_SEED)
        t0_ms = T_START - T_START % DASH_STEP
        ts, vals = counters(rng, TOOL_SERIES, TOOL_SAMPLES, t0_ms)
        t0 = time.perf_counter()
        for lo in range(0, TOOL_SAMPLES, SCRAPES_PER_CALL):
            body = write_request(labels, ts[:, lo:lo + SCRAPES_PER_CALL],
                                 vals[:, lo:lo + SCRAPES_PER_CALL])
            code, resp, _ = c.post("/api/v1/write", body,
                                   {"Content-Encoding": "snappy"})
            if code != 204:
                raise AssertionError(f"tooling write: {code} {resp[:300]}")
        write_s = time.perf_counter() - t0
        last = t0_ms + (TOOL_SAMPLES - 1) * SCRAPE
        state = {"last": last, "end": last - last % DASH_STEP}
        before = server.metrics()

        def moved() -> bool:
            now = server.metrics()
            return all(now[m] > before[m] for m in TOOL_KERNELS.values())
        act = tool_activities(c, Feed(TOOL_SEED + 1, vals[:, -1]), labels,
                              state, moved)
        after = server.metrics()
        tracer = {n: after[n] for n in TOOL_TRACER_METRICS}
        if tracer["vm_locktrace_cycles_total"] or \
                tracer["vm_race_reports_total"]:
            text = server.log().decode(errors="replace")
            reports = [blk for blk in re.split(r"\n(?=\S)", text)
                       if "RaceWarning" in blk or "LockOrder" in blk]
            raise AssertionError(f"tooling: tracers report {tracer}:\n" +
                                 "\n".join(reports[:4])[-6000:])
        calls = {k: after[m] - before[m] for k, m in TOOL_KERNELS.items()}
        if not all(calls.values()):
            raise AssertionError(f"tooling: device counters {calls}: K1, "
                                 f"K2 and K3 must each move; {act}")
        # the sum panel once the writers stopped, then the host evaluator
        # on the same store once the server has closed it
        end = state["end"]
        grid = (end - TOOL_WINDOW, end, DASH_STEP)
        got, ms = c.json("/api/v1/query_range",
                         query=PANEL_TEXTS["sum_by_instance"],
                         start=grid[0] / 1e3, end=end / 1e3,
                         step=DASH_STEP / 1e3)
        if got.get("isPartial"):
            raise AssertionError("tooling final panel: partial")
        got = body_result(got)
        t0 = time.perf_counter()
        rc = server.stop()
        stop_s = time.perf_counter() - t0
        if rc != 0 or b"shutdown complete" not in server.log():
            raise AssertionError(f"tooling: vmsingle exit {rc}: "
                                 f"{server.log()[-2000:]!r}")
        store = Storage(server.path)
        try:
            t0 = time.perf_counter()
            host = tool_host_sum(store, grid)
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            store.close()
        err = keyed_close("tooling sum panel vs the host's one-by-one sum",
                          got, host, 1e-12, 0.0)
        bitwise = sum([v for _, v in got[k]] == [v for _, v in host[k]]
                      for k in host)
    finally:
        if server is not None:
            server.kill()
        shutil.rmtree(root, ignore_errors=True)
    res = {"phase": "tooling", "ok": True, "build_cache": cache,
           "server": {"env": TOOL_ENV, "backend": "default (card)",
                      "start_s": server.start_s, "series": TOOL_SERIES,
                      "samples_per_series": TOOL_SAMPLES,
                      "write_s": write_s, "stop_s": stop_s},
           "activities": act, "tracers": tracer, "device_calls": calls,
           "final_panel": {"round_trip_ms": ms, "series": len(got),
                           "vs_host_in_turn_max_abs_err": err,
                           "rtol": 1e-12, "series_bitwise_equal": bitwise,
                           "host_ms": host_ms},
           "wall_s": time.perf_counter() - t_phase}
    emit(res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of every workload")
    ap.add_argument("--full-hours", type=float, default=FULL_HOURS,
                    help="hours of history in the full_width phase (cut "
                    "only this, never series, groups, step or window)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    t0 = time.perf_counter()
    build_s = kernels.build()
    for name in kernels.SOURCES:
        kernels.lib(name)
    # the host codec too, so that no cold query's time holds its g++ build
    t1 = time.perf_counter()
    native.build()
    native_s = time.perf_counter() - t1
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "load_seconds": time.perf_counter() - t0,
          "native_codec_seconds": native_s, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_tooling()
    rng = np.random.default_rng(args.seed)
    kres, fleet_err = phase_kernels(rng, dev)
    stores = Stores()
    try:
        dash, dash_state = phase_dashboard(rng, dev, stores)
        replay = dash_state.pop("replay")
        http_state = dash_state.pop("http")
        fl = phase_fleet(rng, dev, dash_state)
        del dash_state
        http = phase_http(dev, http_state, dash)
        sat = phase_satellites(http_state)
        ops = phase_operations(http_state)
        del http_state
        for name in FLEET_KERNELS:
            kres[name] = {**fl["kernels"][name], "max_abs_err": max(
                fleet_err[name], fl["kernels"][name]["max_abs_err"])}
        _, fw = phase_full_width(rng, dev, args.full_hours)
        phase_host_codec(rng, replay, fw)
        _, fw_store = phase_ingest(rng, stores, fw)
        hour = cluster_hour(fw)
        mesh = phase_mesh(dev, replay, fw, fw_store)
        del replay, fw, fw_store
        cl = phase_cluster(dev, hour, stores)
        del hour
    finally:
        stores.close_all()
    # B1-B8 count on the dashboard path, B9-B11 on the fleet's, B12-B15 on
    # the mesh phase's; the http phase's launches (its path through the
    # server: K1-B10), the satellites phase's (its rules and vmalert's
    # queries through the server: K1, K2), the operations phase's (the
    # proxied, restored and migrated queries: K1, K2) and the cluster
    # phase's (K1 and K2 through vmselect) are added to them
    launches = {**dash["launches"], **fl["launches"],
                **{k: mesh["launches"][k] for k in MESH_KERNELS}}
    for phase in (http, sat, ops, cl):
        for name, n in phase["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for name in SOURCES:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched on its path")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"],
         "library_ms": kres[name].get("library_ms")}
        for name in SOURCES]})
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
