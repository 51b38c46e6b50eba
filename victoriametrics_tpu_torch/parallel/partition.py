"""Declarative partition rules for the (series, time) device mesh.

Port of ``victoriametrics_tpu/parallel/partition.py``.  Tile leaves are
*named*; a regex table maps each name onto the mesh axes, and every
placement decision derives from that one table.

Layout contract:

- packed sample planes and rollup blocks ``[S, ...]`` (``ts``, ``values``,
  the delta planes' ``*_d2``) shard their leading (series) row axis over
  ``AXIS_SERIES``; the sample/time axis stays local, so windowed rollups
  never need a halo on this path.
- per-series vectors ``[S]`` (``counts``, ``group_ids``, ``v0``,
  ``scale``, ``slots``, the delta planes' firsts/fdeltas) shard over
  ``AXIS_SERIES`` too.
- the fleet's ``[B, ...]`` planes shard their leading stream axis over
  ``AXIS_STREAM``.
- aggregated ``[G, T]`` outputs and scalars (``shift``, ``min_ts``) are
  replicated.

A spec is a tuple of axis names (or None) per dimension, the port's own
spelling of JAX's ``PartitionSpec``.  A sharded tensor is a list of
per-shard tensors, shard i on the device of the mesh's i-th position along
the axis it shards over (``shard_devices``).  ``shard_put`` pads the
sharded axis to a multiple of the mesh axis (kernels mask padded rows via
``counts == 0`` / ``TS_PAD``) and counts the uploaded bytes in the
device-transfer metrics.  Where every shard sits on one device (logical
shards on one card), the array is uploaded once and the shards are row
views of that one buffer: nothing is copied between them.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .. import kernels
from ..models import tile_cache

AXIS_SERIES = "series"
AXIS_TIME = "time"
AXIS_STREAM = "stream"

# regex -> spec per rank: rank-1 leaves drop the trailing None axes.  First
# match wins; an unknown leaf name fails loudly (a silently replicated
# [S, N] plane would land whole on every device).
PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    # fleet-batched planes: the leading stream axis shards over
    # AXIS_STREAM, everything below it stays device-local
    (r"^fleet_(ts|values|vals|out)$", (AXIS_STREAM, None, None)),
    (r"^fleet_(counts|gids|v0)$", (AXIS_STREAM, None)),
    (r"^fleet_(shift|min_ts|aggr)$", (AXIS_STREAM,)),
    # packed (S, N) sample planes / (S, T) rollup blocks / delta planes
    (r"^(ts|values|vals)$", (AXIS_SERIES, None)),
    (r"_d2$", (AXIS_SERIES, None)),
    # per-series vectors
    (r"^(counts|group_ids|gids|slots|v0|scale)$", (AXIS_SERIES,)),
    (r"(_first|_fdelta)$", (AXIS_SERIES,)),
    # aggregated outputs and scalars: replicated
    (r"^(out|shift|min_ts|phi)$", ()),
)


def match_partition_rules(name: str, ndim: int,
                          rules=PARTITION_RULES) -> tuple:
    """The spec of a named tile leaf (first matching rule wins), truncated
    to the leaf's rank.  Scalars are always replicated."""
    if ndim == 0:
        return ()
    for rule, spec in rules:
        if re.search(rule, name) is not None:
            return tuple(spec[:ndim])
    raise ValueError(f"no partition rule matches tile leaf {name!r}")


def row_multiple(mesh) -> int:
    """Series-axis padding multiple for row-sharded tiles."""
    return int(mesh.shape[AXIS_SERIES])


def axis_multiple(mesh, axis: str) -> int:
    """Padding multiple for tiles whose leading axis shards over `axis`
    (1 when there is no mesh or it does not carry that axis)."""
    return int(mesh.shape.get(axis, 1)) if mesh is not None else 1


def pad_rows_to_mesh(mesh, a: np.ndarray, pad_value=0,
                     axis: str = AXIS_SERIES) -> np.ndarray:
    """Pad the leading axis to a multiple of the mesh axis it shards over
    so the shards are equal-sized."""
    n_sh = axis_multiple(mesh, axis)
    S = a.shape[0]
    S_pad = -(-S // n_sh) * n_sh
    if S_pad == S:
        return a
    widths = ((0, S_pad - S),) + ((0, 0),) * (a.ndim - 1)
    return np.pad(a, widths, constant_values=pad_value)


def shard_devices(mesh, axis: str) -> list[torch.device]:
    """The device of each shard along `axis`: the first mesh position of
    each index of that axis."""
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def split_rows(mesh, axis: str, t: torch.Tensor) -> list[torch.Tensor]:
    """Shard a tensor whose leading axis is already a multiple of the
    mesh axis: row views where a shard lies on `t`'s device, else a copy
    of its block on its shard's device."""
    devs = shard_devices(mesh, axis)
    n = len(devs)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} shards")
    r = t.shape[0] // n
    return [t[i * r:(i + 1) * r].to(d, non_blocking=True)
            for i, d in enumerate(devs)]


def shard_put(mesh, name: str, a: np.ndarray, pad_value=0, device=None):
    """Place one named host array per the rule table.  Without a mesh, one
    tensor on `device` (the chunked upload path); on a mesh, the leading
    axis row-padded and split into per-shard tensors when its rule shards
    it, else one copy per shard device.  Every upload goes through
    tile_cache.chunked_device_put, so vm_device_bytes_uploaded_total sees
    every H2D byte."""
    a = np.asarray(a)
    if mesh is None:
        return tile_cache.chunked_device_put(a, device)
    spec = match_partition_rules(name, a.ndim)
    axis = spec[0] if a.ndim and spec else None
    if axis is None:
        devs = list(dict.fromkeys(mesh.devices.flat))
        copies = {d: tile_cache.chunked_device_put(a, d) for d in devs}
        return [copies[d] for d in mesh.devices.flat]
    a = pad_rows_to_mesh(mesh, a, pad_value, axis=axis)
    devs = shard_devices(mesh, axis)
    if len(set(devs)) == 1:
        return split_rows(mesh, axis,
                          tile_cache.chunked_device_put(a, devs[0]))
    r = a.shape[0] // len(devs)
    return [tile_cache.chunked_device_put(a[i * r:(i + 1) * r], d)
            for i, d in enumerate(devs)]


def per_shard(fn, *args):
    """`fn` on each shard of sharded arguments (lists, zipped), or once on
    whole tensors.  Returns a list, or a tuple of lists when `fn` returns
    a tuple."""
    if not isinstance(args[0], list):
        return fn(*args)
    outs = []
    for a in zip(*args):
        with kernels.on_device(a[0].device):
            outs.append(fn(*a))
    if isinstance(outs[0], tuple):
        return tuple(list(o) for o in zip(*outs))
    return outs


def host_rows(t, rows: int | None = None) -> np.ndarray:
    """A tensor, or sharded rows in shard order, on the host (the first
    `rows` rows when given)."""
    if not isinstance(t, list):
        return (t if rows is None else t[:rows]).cpu().numpy()
    a = np.concatenate([s.cpu().numpy() for s in t])
    return a if rows is None else a[:rows]
