"""Binary operators with vector matching (reference
app/vmselect/promql/binary_op.go:15-205).

Arithmetic, comparison (filtering or bool), set ops (and/or/unless), and the
MetricsQL extensions default/if/ifnot. Matching: one-to-one by full label
signature (minus metric name) or on()/ignoring(); many-to-one via
group_left/group_right with optional label copying.

The port's copy of ``victoriametrics_tpu/query/binary_op.py``, whole.
"""

from __future__ import annotations

import numpy as np

from ..storage.metric_name import MetricName
from .types import Timeseries

nan = np.nan


def _arith(fn):
    def wrapped(a, b):
        with np.errstate(all="ignore"):
            return fn(a, b)
    return wrapped


ARITH_OPS = {
    "+": _arith(lambda a, b: a + b),
    "-": _arith(lambda a, b: a - b),
    "*": _arith(lambda a, b: a * b),
    "/": _arith(lambda a, b: a / b),
    "%": _arith(lambda a, b: np.fmod(a, b)),
    "^": _arith(lambda a, b: np.power(a, b)),
    "atan2": _arith(lambda a, b: np.arctan2(a, b)),
}

CMP_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}

SET_OPS = {"and", "or", "unless", "default", "if", "ifnot"}


def signature(mn: MetricName, on: list[str] | None, ignoring: list[str] | None
              ) -> tuple:
    """Label signature for matching (metric name excluded unless on() lists
    __name__)."""
    if on is not None:
        keys = set(on)
        items = []
        for k in sorted(keys):
            kb = k.encode()
            if kb == b"__name__":
                items.append((kb, mn.metric_group))
            else:
                v = mn.get_label(kb)
                items.append((kb, v or b""))
        return tuple(items)
    ig = {k.encode() for k in (ignoring or [])}
    return tuple((k, v) for k, v in mn.labels if k not in ig)


def merge_values_non_overlapping(dv: np.ndarray, sv: np.ndarray) -> bool:
    """Array-level mergeNonOverlappingTimeseries (binary_op.go:367): merge
    src values into dst in place when they overlap in <=2 points and have
    enough points; src wins at the (<=2) overlap points."""
    overlaps = int((~np.isnan(sv) & ~np.isnan(dv)).sum())
    if overlaps > 2:
        return False
    if sv.size <= 2 and dv.size <= 2:
        return False
    ok = ~np.isnan(sv)
    dv[ok] = sv[ok]
    return True


def _merge_non_overlapping(dst: Timeseries, src: Timeseries) -> bool:
    """Merge src into dst when they overlap in <=2 points and have enough
    points (binary_op.go:367 mergeNonOverlappingTimeseries): duplicate
    signatures from complementary filters like (m<10, m>=10) combine."""
    return merge_values_non_overlapping(dst.values, src.values)


def _group_by_sig(series, on, ignoring):
    m: dict[tuple, list] = {}
    order = []
    for ts in series:
        sig = signature(ts.metric_name, on, ignoring)
        if sig not in m:
            order.append(sig)
        m.setdefault(sig, []).append(ts)
    return m, order


def _merge_group(tss, side: str, op: str) -> Timeseries:
    """Collapse one signature group by non-overlapping merge; raise only
    when the group genuinely overlaps (ensureSingleTimeseries semantics —
    unmatched groups never reach this)."""
    cur = Timeseries(tss[0].metric_name, tss[0].values.copy())
    for ts in tss[1:]:
        if not _merge_non_overlapping(cur, ts):
            raise ValueError(
                f"duplicate time series on the {side} side of {op}: "
                f"{ts.metric_name}")
    return cur


def _result_labels(left_mn: MetricName, keep_name: bool) -> MetricName:
    return MetricName(left_mn.metric_group if keep_name else b"",
                      list(left_mn.labels))


def _set_join_tags(mn, add: list[bytes], prefix: bytes, skip: set[bytes],
                   src) -> None:
    """metric_name.go:317 SetTags: copy the join tags from the one side onto
    the result. `*` copies ALL non-skip tags; a named tag missing on the one
    side is REMOVED from the result; `prefix` prepends to copied tag names."""
    if add == [b"*"]:
        for k, v in src.labels:
            if k in skip:
                continue
            nk = prefix + k
            mn.labels = [(a, b) for a, b in mn.labels if a != nk]
            mn.labels.append((nk, v))
        mn.sort_labels()
        return
    for tag in add:
        if tag in skip:
            continue
        if tag == b"__name__":
            mn.metric_group = src.metric_group
            continue
        v = src.get_label(tag)
        if v is not None:
            # SetTagBytes only overwrites prefix+tag; with a prefix the
            # many side's own unprefixed tag survives (metric_name.go:344)
            mn.labels = [(a, b) for a, b in mn.labels if a != prefix + tag]
            mn.labels.append((prefix + tag, v))
        else:
            # missing on the one side: the UNPREFIXED tag is removed
            # (metric_name.go:341 RemoveTag(tagName))
            mn.labels = [(a, b) for a, b in mn.labels if a != tag]
    mn.sort_labels()


def eval_binary_op(op: str, left: list[Timeseries], right: list[Timeseries],
                   bool_modifier: bool, group_mod, join_mod,
                   keep_metric_names: bool, is_cmp_with_scalar_right=None
                   ) -> list[Timeseries]:
    on = group_mod.args if group_mod.op == "on" else None
    ignoring = group_mod.args if group_mod.op == "ignoring" else None

    if op in SET_OPS:
        return _eval_set_op(op, left, right, on, ignoring)

    is_cmp = op in CMP_OPS
    fn = CMP_OPS[op] if is_cmp else ARITH_OPS[op]

    swap = join_mod.op == "group_left"
    # group_left: many on the LEFT match one on the right; group_right is the
    # mirror. We normalize to "many" and "one" sides.
    if join_mod.op == "group_right":
        many, one = right, left
    elif join_mod.op == "group_left":
        many, one = left, right
    else:
        many = one = None

    out: list[Timeseries] = []
    if many is not None:
        # binary_op.go:304 groupJoin: each many-side series pairs with EVERY
        # matching one-side series; the join tags copied from the one side
        # (with optional `prefix`) must make the results unique, else the
        # one-side values are merged when non-overlapping (duplicate error
        # otherwise).
        one_groups, _ = _group_by_sig(one, on, ignoring)
        extra = [l.encode() for l in join_mod.args]
        prefix = getattr(join_mod, "prefix", "").encode()
        skip = {k.encode() for k in on} if on is not None else set()
        keep = keep_metric_names or (is_cmp and not bool_modifier)
        pairs: list[tuple] = []           # (joined MetricName, many, one)
        for m_ts in many:
            grp = one_groups.get(signature(m_ts.metric_name, on, ignoring))
            if grp is None:
                continue
            # the duplicate-name map resets per many-side series
            # (binary_op.go:331); identical joined names from DIFFERENT
            # many series are legal duplicate outputs
            pair_idx: dict[bytes, int] = {}
            for o_ts in grp:
                mn = _result_labels(m_ts.metric_name, keep)
                _set_join_tags(mn, extra, prefix, skip, o_ts.metric_name)
                if len(grp) == 1:
                    pairs.append((mn, m_ts, o_ts))
                    continue
                key = mn.marshal()
                hit = pair_idx.get(key)
                if hit is None:
                    pair_idx[key] = len(pairs)
                    # merge destination: values must be OWNED — the merge
                    # below writes in place, and o_ts.values may be a
                    # read-only result-cache view (or shared with other
                    # pairs via copy_shallow_labels)
                    pairs.append((mn, m_ts,
                                  Timeseries(o_ts.metric_name,
                                             o_ts.values.copy())))
                elif not _merge_non_overlapping(pairs[hit][2], o_ts):
                    raise ValueError(
                        f"duplicate time series on the 'one' side of "
                        f"{op} {join_mod.op}: {mn}")
        for mn, m_ts, o_ts in pairs:
            lv, rv = (m_ts.values, o_ts.values)
            a, b = (lv, rv) if join_mod.op == "group_left" else (rv, lv)
            vals = _apply(fn, a, b, is_cmp, bool_modifier,
                          keep_left=m_ts.values)
            out.append(Timeseries(mn, vals))
        return out

    right_groups, _ = _group_by_sig(right, on, ignoring)
    left_groups, left_order = _group_by_sig(left, on, ignoring)
    for sig in left_order:
        r_grp = right_groups.get(sig)
        if r_grp is None:
            continue  # unmatched groups are dropped, duplicates and all
        l_ts = _merge_group(left_groups[sig], "left", op)
        r_ts = _merge_group(r_grp, "right", op)
        vals = _apply(fn, l_ts.values, r_ts.values, is_cmp, bool_modifier,
                      keep_left=l_ts.values)
        keep_name = keep_metric_names or (is_cmp and not bool_modifier)
        mn = _result_labels(l_ts.metric_name, keep_name)
        if on is not None:
            # RemoveTagsOn (metric_name.go:247) resets the metric group
            # unless __name__ is in the on-list; only an explicit
            # keep_metric_names adds it there (binary_op.go:238) — a non-bool
            # comparison does NOT survive the on() reduction
            keep = {k.encode() for k in on}
            mn.labels = [(k, v) for k, v in mn.labels if k in keep]
            if b"__name__" not in keep and not keep_metric_names:
                mn.metric_group = b""
        elif ignoring is not None:
            # reference binary_op.go one-to-one branch calls
            # MetricName.RemoveTagsIgnoring(groupTags): ignored labels are
            # dropped from the result series
            drop = {k.encode() for k in ignoring}
            mn.labels = [(k, v) for k, v in mn.labels if k not in drop]
        out.append(Timeseries(mn, vals))
    return out


def _apply(fn, a, b, is_cmp, bool_modifier, keep_left):
    if not is_cmp:
        return np.asarray(fn(a, b), dtype=np.float64)
    with np.errstate(all="ignore"):
        m = fn(a, b)
    m = m & ~np.isnan(a) & ~np.isnan(b)
    if bool_modifier:
        out = m.astype(np.float64)
        out[np.isnan(a) | np.isnan(b)] = nan
        return out
    return np.where(m, keep_left, nan)


def _group_map(series, on, ignoring):
    m: dict[tuple, list] = {}
    for ts in series:
        m.setdefault(signature(ts.metric_name, on, ignoring), []).append(ts)
    return m


def _any_right_value(rights):
    """[T] bool: does ANY series in the group have a value at each step."""
    return ~np.all(np.vstack([np.isnan(r.values) for r in rights]), axis=0)


def _is_scalar_group(tss) -> bool:
    return (len(tss) == 1 and not tss[0].metric_name.metric_group
            and not tss[0].metric_name.labels)


def _series_by_key(m: dict, sig):
    """mr lookup with the reference's seriesByKey fallback: a lone
    scalar-signature right group matches every left signature."""
    got = m.get(sig)
    if got is not None:
        return got
    if len(m) == 1:
        (only,) = m.values()
        if _is_scalar_group(only):
            return only
    return None


def _eval_set_op(op, left, right, on, ignoring):
    """Group-based per-point set ops (binary_op.go:416-623): groups are the
    on()/ignoring() signature; and/if mask left to right-present points,
    unless/ifnot to right-absent, default fills left gaps from the group,
    or merges per point (with whole-labelset merge for identical series)."""
    ml = _group_map(left, on, ignoring)
    mr = _group_map(right, on, ignoring)
    out: list[Timeseries] = []

    if op in ("and", "if"):
        for sig, lefts in ml.items():
            rights = mr.get(sig) if op == "and" else _series_by_key(mr, sig)
            if not rights:
                continue
            has = _any_right_value(rights)
            for ts in lefts:
                out.append(Timeseries(ts.metric_name,
                                      np.where(has, ts.values, nan)))
        return out

    if op in ("unless", "ifnot"):
        for sig, lefts in ml.items():
            rights = (mr.get(sig) if op == "unless"
                      else _series_by_key(mr, sig))
            if not rights:
                out.extend(lefts)
                continue
            has = _any_right_value(rights)
            for ts in lefts:
                out.append(Timeseries(ts.metric_name,
                                      np.where(has, nan, ts.values)))
        return out

    if op == "default":
        if not ml:
            for rights in mr.values():
                out.extend(rights)
            return out
        for sig, lefts in ml.items():
            rights = _series_by_key(mr, sig)
            if not rights:
                out.extend(lefts)
                continue
            for ts in lefts:
                vals = ts.values.copy()
                for r in rights:
                    gap = np.isnan(vals)
                    if not gap.any():
                        break
                    vals[gap] = r.values[gap]
                out.append(Timeseries(ts.metric_name, vals))
        return out

    if op == "or":
        # left side first (non-empty series), then per-group right handling
        # (binary_op.go:483 binaryOpOr)
        kept_left: dict[tuple, list] = {}
        for sig, lefts in ml.items():
            # copies: the merge below fills left gaps in place
            keep = [Timeseries(ts.metric_name, ts.values.copy())
                    for ts in lefts if not np.isnan(ts.values).all()]
            kept_left[sig] = keep
            out.extend(keep)
        out.sort(key=lambda ts: ts.metric_name.marshal())
        n_left = len(out)
        for sig, rights in mr.items():
            lefts = kept_left.get(sig)
            if not lefts:
                out.extend(rights)
                continue
            rights = [Timeseries(r.metric_name, r.values.copy())
                      for r in rights]
            scalar_right = _is_scalar_group(rights)
            for ts in lefts:
                merged_scalar = scalar_right and _is_scalar_group([ts])
                lname = ts.metric_name.marshal()
                for r in rights:
                    mergeable = merged_scalar or                         r.metric_name.marshal() == lname
                    left_nan = np.isnan(ts.values)
                    if mergeable:
                        ts.values[left_nan] = r.values[left_nan]
                        r.values[:] = nan
                    else:
                        r.values[~left_nan] = nan
            extra = [r for r in rights if not np.isnan(r.values).all()]
            extra.sort(key=lambda ts: ts.metric_name.marshal())
            out.extend(extra)
        out[n_left:] = sorted(out[n_left:],
                              key=lambda ts: ts.metric_name.marshal())
        return out

    raise ValueError(f"unknown set op {op}")
