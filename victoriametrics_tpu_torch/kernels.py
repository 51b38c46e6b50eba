"""Build, load and launch-count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``
(``csrc/*.cuh`` are headers the sources include).  The build happens on
first use, never at import (the CPU test host has no ``nvcc``), into
``_build/`` beside this file; a library's file name carries a digest of its
source, the headers and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  ``build()`` starts one ``nvcc`` per
source, all at once.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.  Wrappers
count their launches in ``LAUNCHES`` (one per wrapper call that launched,
never for the plain PyTorch versions), which ``chip_smoke.py`` zeroes and
reads around the engine's main path.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double

# exported C functions per source, with their ctypes argument types
SIGNATURES = {
    "decode": {
        # first, fdelta, d2, d2_bytes, d2w, counts, scale, ts_out, val_out,
        # S, n, stream
        "vm_decode_plane": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _LL, _I, _P],
    },
    "rollup": {
        # ts, vals, counts, S, N, shift, min_ts, step, instant, counter, mpi,
        # slots, n_irregular, mean, stream
        "vm_rollup_scan": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P, _P, _P],
        # vals, counts, slots, S, N, cv, cmax, stream
        "vm_rollup_prep": [_P, _P, _P, _LL, _I, _P, _P, _P],
        # ts, vals, counts, B, S, N, shifts, min_tss, step, instant,
        # counter, mpi, slots, n_irregular, mean, stream
        "vm_fleet_rollup_scan": [_P, _P, _P, _LL, _LL, _I, _P, _P, _I, _I,
                                 _I, _P, _P, _P, _P, _P],
        # vals, counts, slots, v0, B, S, N, cv, cmax, stream
        "vm_fleet_rollup_prep": [_P, _P, _P, _P, _LL, _LL, _I, _P, _P, _P],
        # ts, vals, cv, cmax, slots, counts, mpi, mean, order, starts, G, N,
        # T, shift, min_ts, step, lookback, start_s, func, aggr, out, stream
        "vm_rollup_groups": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                             _I, _I, _I, _I, _I, _D, _I, _I, _P, _P],
        # ts, vals, cv, cmax, slots, counts, mpi, mean, S, N, T, shift,
        # min_ts, step, lookback, start_s, func, out, ldo, stream
        "vm_rollup_series": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                             _I, _I, _I, _D, _I, _P, _LL, _P],
        # ts, vals, cv, cmax, slots, counts, mpi, mean, order, starts, G, N,
        # T, shift, min_ts, step, lookback, start_s, func, aggr, out, stream
        "vm_rollup_group_moments": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _LL, _I, _I, _I, _I, _I, _I, _D, _I, _I,
                                    _P, _P],
        # S, n, func, force_global, blocks (out), scratch_bytes (out)
        "vm_decode_rollup_plan": [_LL, _I, _I, _I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_LL)],
        # ts_first, ts_fd, ts_d2, ts_d2_bytes, ts_d2w, val_first, val_fd,
        # val_d2, val_d2_bytes, val_d2w, scale, counts, S, n, T, min_ts,
        # step, lookback, start_s, instant, func, force_global, scratch,
        # out, stream
        "vm_decode_rollup": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P,
                             _LL, _I, _I, _I, _I, _I, _D, _I, _I, _I, _P,
                             _P, _P],
        # ts, vals, cv, cmax, slots, counts, mpi, mean, v0, order, starts,
        # shifts, min_tss, aggrs, B, S, G, N, T, step, lookback, start_s,
        # func, out, stream
        "vm_fleet_rollup_groups": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I,
                                   _D, _I, _P, _P],
    },
    "select": {
        # S, T, k, bytes (out): the scratch vm_topk_select needs
        "vm_topk_scratch": [_LL, _I, _I, ctypes.POINTER(_LL)],
        # rolled, S, T, k, bottom, scratch, out_idx, out_nan, stream
        "vm_topk_select": [_P, _LL, _I, _I, _I, _P, _P, _P, _P],
        # rolled, S, T, sel, M, out, stream
        "vm_take_rows": [_P, _LL, _I, _P, _LL, _P, _P],
        # rolled, S, T, kind, rank, stream
        "vm_rank_rows": [_P, _LL, _I, _I, _P, _P],
    },
    "quantile": {
        # rolled, T, order, starts, G, max_group, phi, out, stream
        "vm_quantile_groups": [_P, _I, _P, _P, _LL, _I, _D, _P, _P],
    },
    "mesh": {
        # moments, D, M, GT, aggr, out, stream
        "vm_combine_moments": [_P, _I, _I, _LL, _I, _P, _P],
        # ts, ts_ld, vals, vals_ld, valid, valid_ld, h_ts, h_ts_ld, h_vals,
        # h_vals_ld, h_valid, h_valid_ld, R, C, H, shift, ts_out, vals_out,
        # counts, stream
        "vm_halo_compact": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P,
                            _LL, _LL, _I, _I, _I, _P, _P, _P, _P],
        # out, ld, R, cols, shift, stream
        "vm_add_seconds": [_P, _LL, _LL, _I, _I, _P],
    },
    "tile": {
        # ts, vals, counts, new_ts, new_vals, new_counts, S, N, K, stream
        "vm_append_tile": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
        # ts, vals, counts, ts_out, vals_out, counts_out, S, N, cutoff,
        # delta, stream
        "vm_compact_tile": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
        # ts, vals, counts, new_ts, new_vals, new_counts, B, S, N, K, stream
        "vm_fleet_append_tile": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                                 _P],
        # ts, vals, counts, ts_out, vals_out, counts_out, cutoffs, deltas,
        # B, S, N, stream
        "vm_fleet_compact_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                                  _I, _P],
    },
}
SOURCES = tuple(SIGNATURES)

#: launches per kernel wrapper (see module docstring)
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_loads = 0


def reset_launches() -> None:
    LAUNCHES.clear()


def loads() -> int:
    """How many kernel libraries this process has loaded so far."""
    return _loads


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(PATH and /usr/local/cuda/bin searched)")
    return path


def library_path(name: str) -> Path:
    # the headers are included by the sources: a changed header rebuilds
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(),
                             digest_size=8).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent; raises
    with the compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    global _loads
    with _lock:
        h = _libs.get(name)
        if h is not None:
            return h
        build((name,))
        h = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(h, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        h.vm_cuda_error_string.argtypes = [ctypes.c_int]
        h.vm_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = h
        _loads += 1
        return h


def check(h: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C launcher reported a CUDA error."""
    if rc != 0:
        msg = h.vm_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device):
    """Context making a CUDA ``device`` the current one (a launch must go
    to a stream of the current device); nothing for the CPU.  The mesh
    layer wraps each shard's launches in it."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def placement(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on: the wrappers run the plain
    PyTorch version for the CPU and the kernel for CUDA, and refuse a mix
    or any other device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Validate a kernel argument before its pointer crosses into C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
