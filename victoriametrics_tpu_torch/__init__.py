"""victoriametrics_tpu_torch — the PyTorch/CUDA port of victoriametrics_tpu.

The device query engine for fused ``aggr(rollup(selector[window]))`` range
queries, cold and rolling, on one NVIDIA H100.  Plain tensor code is
PyTorch; every device kernel on the engine's path is CUDA C++ written for
Hopper (``csrc/``), built with ``nvcc`` on first use and bound through
``ctypes`` (``kernels.py``).  Each kernel wrapper keeps a plain PyTorch
version beside it, which runs only for tensors on the CPU.

The package imports no JAX and nothing of ``victoriametrics_tpu``; it
keeps its own copies of the host code it needs.  Module names mirror the
JAX package so each counterpart is easy to find:

  ops/       decimal codec, RollupConfig, delta-plane decode (K1), fused
             rollup + group aggregate (K2), rolling append (K3) and
             window compaction (K4)
  storage/   the storage engine: Storage (add_rows, search_series,
             search_columns, the rolling contract), index_db, mergeset,
             table, partition, part, block, columnar
  native/    the host codec (codec.cpp, built by g++ on first use), xxh64
  models/    device tile cache, upload seam, QueryPipeline
  query/     cuda_engine: cold and rolling fused queries; fleet; the
             evaluator; sloplane (SLOs, incidents, health)
  parallel/  the device mesh; the cluster: RPC, consistent hashing, ring
             filter, ClusterStorage (vminsert/vmselect) and the storage
             node's handlers
  apps/      vmsingle, vmstorage, vminsert, vmselect
  utils/     self-metrics registry, self-scrape, pushmetrics and the
             storage's helpers (fs, work pool, working-set cache,
             deadlines, logger)
  devtools/  the lint (VMT006: host syncs in the kernel wrappers), the
             call-graph passes, the wire-schema ratchet, the lock and
             race tracers, the scheduler, the fault injector, smokes
  convert.py load the JAX engine's resident state into the port
"""

__version__ = "0.1.0"
