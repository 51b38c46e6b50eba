"""Build-cache smoke: a second cold process, started on a built tree, must
start the compiler ZERO times, yet load every kernel library and the
native library and launch a kernel.  Without this gate a drift in a
library's name (the digest over its sources and flags,
``kernels.library_path``, ``native.library_path``) silently reverts every
restart to paying the full ``nvcc`` build.

The port's counterpart of ``victoriametrics_tpu/devtools/compile_cache_smoke.py``
(it keeps the file name so a reader finds it): JAX's persistent compile
cache is replaced by the built libraries under ``_build/``, the CUDA
kernels of ``kernels.SOURCES`` (one ``nvcc`` per source) and the native
library of ``native.SOURCES`` (one ``g++``).

Two child processes on the same tree.  Each counts the compiler processes
it starts (``nvcc``, ``g++``/``c++``/``$CXX``), loads every library in
``kernels.SOURCES`` and the native one, launches K3 (``append_tile``) on
the card once and holds it against its plain version, and prints one JSON
line.  The first child builds what is missing; the second must report 0
builds, every library loaded and one launch.  The parent prints one JSON
line, ``{"check": "build_cache", "ok": ..., "children": [...]}``.

Where no ``nvcc`` is found the smoke says so loudly and exits 0, as the
reference does where its cache cannot work; nothing else falls back (no
card, a failed build or a missing library fail it).
``VMT_NO_COMPILE_CACHE_SMOKE=1`` skips it from ``tools/lint_torch.sh``.

Run directly: ``python -m victoriametrics_tpu_torch.devtools.compile_cache_smoke``
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_COMPILERS = ("nvcc", "g++", "c++")


def _load_libraries(kernels, native) -> None:
    """Load (building where missing) every kernel library and the
    native one."""
    for name in kernels.SOURCES:
        kernels.lib(name)
    if native._load() is None:
        raise RuntimeError("the native library did not load")


def _child() -> int:
    t0 = time.perf_counter()
    started: list[str] = []
    compilers = set(_COMPILERS) | {os.path.basename(
        os.environ.get("CXX", "g++"))}
    real_popen = subprocess.Popen

    class _Counting(real_popen):
        def __init__(self, args, *a, **k):
            argv = [args] if isinstance(args, (str, bytes)) else list(args)
            exe = os.path.basename(os.fspath(argv[0])) if argv else ""
            if exe in compilers:
                started.append(exe)
            super().__init__(args, *a, **k)

    subprocess.Popen = _Counting
    try:
        import torch

        from .. import kernels, native
        from ..ops import device_rollup as dr
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the kernels cannot launch")
        _load_libraries(kernels, native)
        dev = torch.device("cuda", 0)
        g = torch.Generator().manual_seed(7)
        S, N, K = 64, 32, 8
        counts = torch.full((S,), N - K, dtype=torch.int32)
        ts = torch.arange(N, dtype=torch.int32).repeat(S, 1) * 15_000
        vals = torch.rand((S, N), generator=g, dtype=torch.float64)
        new_ts = ts[:, :K] + (N - K) * 15_000
        new_vals = torch.rand((S, K), generator=g, dtype=torch.float64)
        new_counts = torch.full((S,), K, dtype=torch.int32)
        want = dr.append_tile_plain(ts.clone(), vals.clone(), counts.clone(),
                                    new_ts, new_vals, new_counts)
        before = kernels.LAUNCHES["append_tile"]
        got = dr.append_tile(*(t.to(dev) for t in (
            ts, vals, counts, new_ts, new_vals, new_counts)))
        launches = kernels.LAUNCHES["append_tile"] - before
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        if not same:
            raise RuntimeError("append_tile disagrees with its plain version")
        out = {"builds": len(started), "compilers": sorted(set(started)),
               "kernel_libs": kernels.loads(),
               "kernel_sources": len(kernels.SOURCES),
               "native": True, "launches": launches,
               "wall_s": time.perf_counter() - t0}
    finally:
        subprocess.Popen = real_popen
    print(json.dumps(out))
    return 0


def _spawn() -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m",
         "victoriametrics_tpu_torch.devtools.compile_cache_smoke", "--child"],
        capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"child failed rc={p.returncode}:\n"
                           f"{p.stdout}\n{p.stderr}")
    rep = json.loads(p.stdout.strip().splitlines()[-1])
    rep["process_s"] = time.perf_counter() - t0
    return rep


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--child" in argv:
        return _child()
    from .. import kernels
    try:
        kernels.nvcc()
    except RuntimeError as e:
        print(f"build-cache smoke: SKIP ({e}; nothing to cache)")
        return 0
    children = [_spawn(), _spawn()]
    warm = children[1]
    failures = []
    if warm["builds"] != 0:
        failures.append(f"warm child started the compiler {warm['builds']} "
                        f"time(s) ({', '.join(warm['compilers'])}) on a "
                        f"built tree")
    if warm["kernel_libs"] != warm["kernel_sources"]:
        failures.append(f"warm child loaded {warm['kernel_libs']} of "
                        f"{warm['kernel_sources']} kernel libraries")
    if warm["launches"] != 1:
        failures.append(f"warm child launched append_tile "
                        f"{warm['launches']} times, expected 1")
    ok = not failures
    for f in failures:
        print(f"build-cache smoke: FAIL: {f}")
    if ok:
        print(f"build-cache smoke: OK (cold {children[0]['builds']} "
              f"builds -> warm 0, {warm['kernel_libs']} kernel libraries "
              f"and the native one loaded, 1 launch)")
    print(json.dumps({"check": "build_cache", "ok": ok,
                      "children": children}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
