"""Load state built by the JAX engine into the port.

The query engine has no weights: a resident tile (or the delta planes it
is decoded from) is its state.  The tests give both engines the same state
through these functions, with the reference's arrays handed over as numpy
(``np.asarray`` of the JAX arrays) so this package never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_PLANE_FIELDS = ("ts_first", "ts_fdelta", "ts_d2", "val_first",
                 "val_fdelta", "val_d2", "scale", "counts")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def tiles_from_reference(ts, values, counts, device):
    """The reference's resident tile (ts int32 [S, N], values [S, N],
    counts [S]) -> the port's tile tuple (int32, float64, int32) on
    `device`, each a fresh tensor."""
    return (_tensor(ts, np.int32, device), _tensor(values, np.float64, device),
            _tensor(counts, np.int32, device))


def planes_from_reference(planes, device) -> tuple:
    """A DeltaPlanes-like object (the reference's or the port's) -> the
    eight plane tensors on `device`, in ``decode_tiles`` argument order,
    each keeping its array's dtype."""
    arrays = [np.asarray(getattr(planes, f)) for f in _PLANE_FIELDS]
    return tuple(_tensor(a, a.dtype, device) for a in arrays)
