"""Decimal codec: float64[] <-> (int64 mantissas, common decimal exponent).

The port's own copy of ``victoriametrics_tpu/ops/decimal.py`` (reference
lib/decimal/decimal.go AppendFloatToDecimal, AppendDecimalToFloat,
CalibrateScale): the cold upload turns the series' float64 values into
integer mantissas before packing nearest-delta2 planes, one
``float_to_decimal_grouped`` call for every series of more than 8 samples
(native at 256 samples and above, ``native/codec.cpp`` vm_f2d_grouped).
Host numpy only, bit-identical to the reference module, which the tests
hold it against.

Values are stored as int64 mantissas sharing one decimal exponent,
``v ~= m * 10^e``.  Special float values map to reserved int64 constants:

  NaN        -> V_NAN
  StaleNaN   -> V_STALE_NAN  (Prometheus staleness marker, bits 0x7ff0000000000002)
  +Inf/-Inf  -> V_INF_POS / V_INF_NEG

Normal mantissas are bounded by MAX_MANTISSA (1e17, ~17 significant digits).
"""

from __future__ import annotations

import numpy as np

# Reserved int64 sentinels (chosen to leave |m| <= MAX_MANTISSA for normal values).
V_NAN = -(1 << 63)
V_STALE_NAN = -(1 << 63) + 1
V_INF_NEG = -(1 << 63) + 2
V_INF_POS = (1 << 63) - 1

MAX_MANTISSA = 10 ** 17
_SIG_DIGITS = 17  # max significant decimal digits kept

# Prometheus staleness marker: a specific quiet-NaN bit pattern.
STALE_NAN_BITS = np.uint64(0x7FF0000000000002)
STALE_NAN = float(np.uint64(STALE_NAN_BITS).view(np.float64))

_MIN_EXP = -320
_MAX_EXP = 310


def is_stale_nan(values: np.ndarray) -> np.ndarray:
    """Elementwise test for the staleness-marker NaN (bit-exact)."""
    v = np.asarray(values, dtype=np.float64)
    return v.view(np.uint64) == STALE_NAN_BITS


# Power-of-ten table built by the SAME multiplicative recurrence as the
# native codec (T[k] = T[k-1]*10, T[-k] = 1/T[k]): exact for |e| <= 22 and
# bit-identical across the Python and C++ pipelines — np.power's SIMD path
# differs from libm pow by an ulp at large exponents, which would make
# native-encoded mantissas diverge from Python-encoded ones.
_POW10_MAX = 340
_POW10_TABLE = np.empty(2 * _POW10_MAX + 1, dtype=np.float64)
_POW10_TABLE[_POW10_MAX] = 1.0
with np.errstate(over="ignore"):
    for _k in range(1, _POW10_MAX + 1):
        _POW10_TABLE[_POW10_MAX + _k] = \
            _POW10_TABLE[_POW10_MAX + _k - 1] * 10.0
        if _POW10_TABLE[_POW10_MAX + _k] != np.inf:
            _POW10_TABLE[_POW10_MAX - _k] = \
                1.0 / _POW10_TABLE[_POW10_MAX + _k]
        else:  # subnormal range: continue by division (1/inf would be 0)
            _POW10_TABLE[_POW10_MAX - _k] = \
                _POW10_TABLE[_POW10_MAX - _k + 1] / 10.0
del _k


def _pow10_float(e):
    """10^e as float64; exact for |e| <= 22 (table-driven, see above)."""
    idx = np.asarray(e, dtype=np.int64) + _POW10_MAX
    return _POW10_TABLE[np.clip(idx, 0, 2 * _POW10_MAX)]


def _scalar_mantissa(x: float) -> tuple[int, int]:
    """(mantissa, exponent) of one finite nonzero float via repr(), which is
    the shortest decimal that round-trips — exactly the digits we want."""
    if x == int(x) and abs(x) <= MAX_MANTISSA:
        m, e = int(x), 0
    else:
        s = repr(x)
        if "e" in s:
            mant, _, ex = s.partition("e")
            e = int(ex)
        else:
            mant, e = s, 0
        intpart, _, frac = mant.partition(".")
        e -= len(frac)
        m = int(intpart + frac)
        if abs(m) > MAX_MANTISSA:  # >17 significant digits can't happen via
            while abs(m) > MAX_MANTISSA:  # repr, but stay safe
                m = int(round(m / 10))
                e += 1
    while m != 0 and m % 10 == 0:
        m //= 10
        e += 1
    return m, e


def _float_to_decimal_small(v: np.ndarray) -> tuple[np.ndarray, int]:
    """Scalar path for tiny arrays (the per-series streaming-flush case):
    ~100x lower fixed overhead than the vectorized path."""
    ms: list[int] = []
    es: list[int] = []
    out = np.empty(v.size, dtype=np.int64)
    kinds: list[int] = []  # 0=normal 1=zero, negatives = specials
    for x in v.tolist():
        if x != x:  # NaN family: bit-test for the staleness marker
            bits = np.float64(x).view(np.uint64)
            kinds.append(-1 if bits == STALE_NAN_BITS else -2)
        elif x == np.inf:
            kinds.append(-3)
        elif x == -np.inf:
            kinds.append(-4)
        elif x == 0.0:
            kinds.append(1)
        else:
            m, e = _scalar_mantissa(x)
            ms.append(m)
            es.append(e)
            kinds.append(0)
    if ms:
        exp = min(min(es), _MAX_EXP)
        for m, e in zip(ms, es):
            up = 0
            am = abs(m)
            while am * 10 ** (up + 1) <= MAX_MANTISSA:
                up += 1
            if e - up > exp:
                exp = e - up
        exp = max(min(exp, _MAX_EXP), _MIN_EXP)
    else:
        exp = 0
    i = 0
    k = 0
    for j, kind in enumerate(kinds):
        if kind == 0:
            m, e = ms[i], es[i]
            x = float(v[j])
            i += 1
            shift = e - exp
            if shift > 0:
                mm = m * 10 ** shift
                if abs(mm) <= (1 << 53) or x == int(x):
                    # exact: small enough for the float cast, or integer-
                    # origin (decimal_to_float recovers those by exact
                    # integer division)
                    m = mm
                else:
                    # fractional + big mantissa: re-derive at the final
                    # exponent like the vector path — repr() digits are the
                    # SHORTEST form, zero-padding them would round-trip off
                    # by an ulp through the float division
                    if exp < 0:
                        k1 = min(-exp, 300)
                        m = int(round(x * 10.0 ** k1 * 10.0 ** (-exp - k1)))
                    else:
                        m = int(round(x / 10.0 ** exp))
            elif shift < 0:
                m = int(round(m / 10 ** min(-shift, 19)))
            out[j] = min(max(m, -MAX_MANTISSA), MAX_MANTISSA)
        elif kind == 1:
            out[j] = 0
        else:
            out[j] = (V_STALE_NAN, V_NAN, V_INF_POS,
                      V_INF_NEG)[-kind - 1]
    return out, exp


def float_to_decimal(values: np.ndarray) -> tuple[np.ndarray, int]:
    """Convert float64 array to (int64 mantissas, common exponent).

    Lossy only when values span more decimal orders than MAX_MANTISSA allows;
    "nice" decimal values (integers, few decimal places) round-trip exactly.
    """
    v = np.asarray(values, dtype=np.float64)
    n = v.size
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    if n <= 8:
        return _float_to_decimal_small(v)
    m, e, normal, specials = _f2d_element_phase(v)
    if normal.any():
        e_norm = e[normal]
        m_norm = m[normal]
        # Common exponent: as small as possible without overflowing mantissas.
        # Scaling m from exponent E down to `exp` multiplies it by 10^(E-exp);
        # the largest allowed up-shift for m is floor(log10(MAX_MANTISSA/|m|)).
        absm = np.abs(m_norm).astype(np.float64)
        absm = np.maximum(absm, 1.0)
        allowed_up = np.floor(np.log10(MAX_MANTISSA / absm)).astype(np.int64)
        exp = int(min(e_norm.min(), _MAX_EXP))
        exp_floor = int((e_norm - allowed_up).max())
        if exp_floor > exp:
            exp = exp_floor
        exp = max(min(exp, _MAX_EXP), _MIN_EXP)
        m = _f2d_rescale(m, e, normal, np.int64(exp))
    else:
        exp = 0
    m = _f2d_apply_specials(m, specials)
    return m, int(exp)


def _f2d_element_phase(v: np.ndarray):
    """Element-wise mantissa/exponent extraction (shared by the per-block
    and grouped entry points): returns (m, e, normal, specials) BEFORE
    common-exponent unification."""
    n = v.size
    stale = is_stale_nan(v)
    nan = np.isnan(v) & ~stale
    posinf = np.isposinf(v)
    neginf = np.isneginf(v)
    zero = v == 0.0
    special = stale | nan | posinf | neginf
    normal = ~special & ~zero

    m = np.zeros(n, dtype=np.int64)
    e = np.zeros(n, dtype=np.int64)

    if normal.any():
        vn = np.where(normal, v, 1.0)
        exp10 = np.floor(np.log10(np.abs(vn))).astype(np.int64)

        def _scale_up(x, e):
            # x * 10^e for e >= 0 without overflowing the float64 power:
            # split the exponent so each factor stays finite (10^e overflows
            # above e=308 even when the product x*10^e is tiny).
            e1 = np.minimum(e, 300)
            e2 = e - e1
            return x * _pow10_float(e1) * _pow10_float(e2)

        def _decompose(digits):
            ei = np.clip(exp10 - (digits - 1), _MIN_EXP, _MAX_EXP)
            # m = round(v / 10^ei); for negative ei multiply by 10^-ei (exact
            # float64 power of ten for small magnitudes) to minimise error.
            scaled = np.where(ei < 0, _scale_up(vn, -ei), vn / _pow10_float(ei))
            mi = np.round(scaled)
            # Guard against 1-off exponent from floor(log10) at power edges.
            over = np.abs(mi) >= 10 ** digits
            if over.any():
                ei = np.where(over, ei + 1, ei)
                scaled = np.where(ei < 0, _scale_up(vn, -ei), vn / _pow10_float(ei))
                mi = np.round(scaled)
            # Clamp before the int64 cast: a residual overflow must saturate
            # at MAX_MANTISSA, never wrap into the reserved sentinel range.
            mi = np.clip(mi, -MAX_MANTISSA, MAX_MANTISSA)
            return mi.astype(np.int64), ei

        # Three-way extraction, first match wins:
        # 1. integer-valued floats up to MAX_MANTISSA: direct int64 cast is
        #    exact (scaling by powers of ten would round above 2^53);
        # 2. 15 significant digits when they reconstruct bit-exactly
        #    (decimal-representable scrape text), giving small mantissas;
        # 3. 17 digits for values needing full float64 precision (e.g. 2/3).
        is_int = (vn == np.floor(vn)) & (np.abs(vn) <= MAX_MANTISSA)
        m15, e15 = _decompose(15)
        recon = np.where(e15 < 0,
                         m15.astype(np.float64) / _pow10_float(-e15),
                         m15.astype(np.float64) * _pow10_float(e15))
        exact15 = recon == vn
        m17, e17 = _decompose(_SIG_DIGITS)
        mi = np.where(is_int, np.where(is_int, vn, 0.0).astype(np.int64),
                      np.where(exact15, m15, m17))
        ei = np.where(is_int, 0, np.where(exact15, e15, e17))
        # Strip trailing decimal zeros (fixed-trip masked loop, max 17 iters).
        for _ in range(_SIG_DIGITS):
            can = (mi != 0) & (mi % 10 == 0) & normal
            if not can.any():
                break
            mi = np.where(can, mi // 10, mi)
            ei = np.where(can, ei + 1, ei)
        m = np.where(normal, mi, m)
        e = np.where(normal, ei, e)
    return m, e, normal, (stale, nan, posinf, neginf)


def _f2d_rescale(m, e, normal, exp):
    """Rescale normal mantissas from their own exponents to `exp` (scalar
    int64 or per-element int64 array)."""
    shift = e - exp
    up = normal & (shift > 0)
    down = normal & (shift < 0)
    if up.any():
        # Exact int64 multiply: the shifted product is bounded by
        # MAX_MANTISSA (1e17 < 2^63) by construction of allowed_up, and a
        # float64 multiply here would corrupt mantissas above 2^53.
        factor = np.power(np.int64(10), np.where(up, shift, 0).astype(np.int64))
        m = np.where(up, m * factor, m)
    if down.any():
        # Lossy: value has more precision than the common scale can hold.
        # Shifts beyond 18 decimal places collapse the mantissa to zero.
        dshift = np.minimum(np.where(down, -shift, 1), 19)
        factor = _pow10_float(dshift)
        m = np.where(down, np.round(m.astype(np.float64) / factor).astype(np.int64), m)
    return m


def _f2d_apply_specials(m, specials):
    stale, nan, posinf, neginf = specials
    m = np.where(stale, V_STALE_NAN, m)
    m = np.where(nan, V_NAN, m)
    m = np.where(posinf, V_INF_POS, m)
    m = np.where(neginf, V_INF_NEG, m)
    return m


def float_to_decimal_grouped(values: np.ndarray, starts: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Per-group float_to_decimal over a concatenation — bit-identical to
    calling float_to_decimal on each segment, but the element-wise phase
    runs ONCE over the whole array and the per-group common-exponent
    unification is reduceat-vectorized. The flush path batches thousands of
    small per-series blocks through this (the per-call overhead of the
    vectorized pipeline dominates at ~24-sample scrape blocks).

    starts: sorted int group start offsets; ends are implied. Returns
    (mantissas, exps[int64, one per group]). Every group rides the same
    vectorized element phase — one batched call amortizes the per-call
    overhead that makes the scalar path attractive for single tiny
    conversions, and per-group Python would otherwise dominate scrape-flush
    conversion (~25us/group). Full-precision (non-decimal) floats may
    round a final ulp differently than the repr-based scalar path; decimal
    data converts identically."""
    v = np.asarray(values, dtype=np.float64)
    starts = np.asarray(starts, dtype=np.int64)
    n_groups = starts.size
    exps = np.zeros(n_groups, dtype=np.int64)
    if v.size == 0 or n_groups == 0:
        return np.zeros(v.size, dtype=np.int64), exps
    if v.size >= 256:
        # bit-identical native twin (differentially tested, shared pow10
        # table) — the flush hot path
        from .. import native
        got = native.f2d_grouped(v, starts)
        if got is not None:
            return got
    ends = np.append(starts[1:], v.size)
    sizes = ends - starts
    m, e, normal, specials = _f2d_element_phase(v)
    BIG = np.int64(1 << 40)
    absm = np.maximum(np.abs(m).astype(np.float64), 1.0)
    allowed_up = np.floor(np.log10(MAX_MANTISSA / absm)).astype(np.int64)
    emin_g = np.minimum.reduceat(np.where(normal, e, BIG), starts)
    floor_g = np.maximum.reduceat(
        np.where(normal, e - allowed_up, -BIG), starts)
    has_norm_g = np.logical_or.reduceat(normal, starts)
    exp_g = np.minimum(emin_g, _MAX_EXP)
    exp_g = np.where(floor_g > exp_g, floor_g, exp_g)
    exp_g = np.clip(exp_g, _MIN_EXP, _MAX_EXP)
    exp_g = np.where(has_norm_g, exp_g, 0)
    exp_elem = np.repeat(exp_g, sizes)
    m_all = _f2d_rescale(m, e, normal, exp_elem)
    m_out = _f2d_apply_specials(m_all, specials)
    return m_out, exp_g.astype(np.int64)


def decimal_to_float(ints: np.ndarray, exponent: int) -> np.ndarray:
    """Convert (int64 mantissas, exponent) back to float64 values.

    Division by an exact power of ten is used for negative exponents so that
    typical decimal values round-trip bit-exactly.
    """
    m = np.asarray(ints, dtype=np.int64)
    stale = m == V_STALE_NAN
    nan = m == V_NAN
    posinf = m == V_INF_POS
    neginf = m == V_INF_NEG
    special = stale | nan | posinf | neginf

    mn = np.where(special, 0, m)
    mf = mn.astype(np.float64)
    if exponent == 0:
        out = mf
    elif exponent < 0:
        if exponent >= -22:
            out = mf / _pow10_float(-exponent)
            if exponent >= -18:
                # Mantissas above 2^53 round in the int64->float64 cast; when
                # the division is exact in integers, divide first instead.
                p = np.int64(10) ** np.int64(-exponent)
                q = mn // p
                exact = (mn - q * p == 0)
                out = np.where(exact, q.astype(np.float64), out)
        else:
            out = mf * _pow10_float(exponent)
    else:
        out = mf * _pow10_float(exponent)

    out = np.where(stale, STALE_NAN, out)
    out = np.where(nan, np.nan, out)
    out = np.where(posinf, np.inf, out)
    out = np.where(neginf, -np.inf, out)
    return out


#: sample count above which one exponent run is split across pool workers
_BLOCKS_SPLIT_MIN = 1 << 19


def decimal_to_float_blocks_py(mants: np.ndarray, goff: np.ndarray,
                               scales: np.ndarray, out: np.ndarray,
                               pool=None) -> np.ndarray:
    """Pure-numpy twin of native.decimal_to_float_blocks: convert
    per-block (mantissa, exponent) columns into float64 `out` in place.

    ``goff`` is the (K+1,) exclusive block-offset prefix; block k owns
    samples [goff[k], goff[k+1]) at exponent ``scales[k]``.

    One sort-by-scale pass: blocks are argsorted by exponent (K log K on
    BLOCK count, not samples), their sample positions gathered once, and
    each distinct exponent converts its whole sample run in one
    decimal_to_float call — O(samples + K log K), replacing the old
    per-exponent full-length repeat mask that made the fallback
    O(samples x distinct_exponents).

    Disjoint runs (and oversized single runs) optionally split across
    ``pool`` (anything with ``.run(list_of_callables)``, as the
    reference's utils/workpool.WorkPool): every task writes a disjoint
    region of ``out``, so parallel execution is bit-identical."""
    K = int(scales.size)
    if K == 0 or out.size == 0:
        return out
    uniq = np.unique(scales)
    if uniq.size == 1:
        # common case (one part, uniform scrape payloads): no gather at all
        out[:] = decimal_to_float(mants, int(uniq[0]))
        return out
    cnts = goff[1:] - goff[:-1]
    order = np.argsort(scales, kind="stable")
    ss = scales[order]
    sorted_cnts = cnts[order]
    tot = int(sorted_cnts.sum())
    excl = np.cumsum(sorted_cnts) - sorted_cnts
    pos = np.repeat(goff[:-1][order] - excl, sorted_cnts) + \
        np.arange(tot, dtype=np.int64)
    runs = []                       # (sample_lo, sample_hi, exponent)
    bstart = np.flatnonzero(np.concatenate([[True], ss[1:] != ss[:-1]]))
    sstart = excl[bstart]
    send = np.append(sstart[1:], tot)
    for lo, hi, e in zip(sstart, send, ss[bstart]):
        lo, hi, e = int(lo), int(hi), int(e)
        # split giant runs so the pool can overlap them too
        step = max(_BLOCKS_SPLIT_MIN, -(-(hi - lo) // 8))
        for a in range(lo, hi, step):
            runs.append((a, min(a + step, hi), e))

    def conv(lo: int, hi: int, e: int):
        p = pos[lo:hi]
        out[p] = decimal_to_float(mants[p], e)

    if pool is not None and len(runs) > 1 and tot >= _BLOCKS_SPLIT_MIN:
        from functools import partial
        pool.run([partial(conv, *r) for r in runs])
    else:
        for r in runs:
            conv(*r)
    return out


def calibrate_scale(a: np.ndarray, a_exp: int, b: np.ndarray, b_exp: int
                    ) -> tuple[np.ndarray, np.ndarray, int]:
    """Bring two mantissa arrays to a common exponent (reference
    CalibrateScale, decimal.go:13). Scales the larger-exponent side up unless
    that overflows MAX_MANTISSA, in which case the smaller side loses digits.
    """
    if a_exp == b_exp:
        return a, b, a_exp
    if a_exp > b_exp:
        b2, a2, e = calibrate_scale(b, b_exp, a, a_exp)
        return a2, b2, e

    # a_exp < b_exp: try to shift b down to a_exp.
    def _specials(x):
        return (x == V_STALE_NAN) | (x == V_NAN) | (x == V_INF_POS) | (x == V_INF_NEG)

    shift = b_exp - a_exp
    bsp = _specials(b)
    babs = np.abs(np.where(bsp, 0, b)).astype(np.float64)
    maxb = babs.max() if b.size else 0.0
    if maxb == 0.0:
        # b has no normal mantissas — zeros scale to any exponent for free.
        return a, b, a_exp
    if shift <= 18 and maxb * (10.0 ** shift) <= MAX_MANTISSA:
        factor = np.int64(10) ** np.int64(shift)
        b2 = np.where(bsp, b, b * factor)
        return a, b2, a_exp
    # Can't shift b down fully: shift a up (lossy on a).
    asp = _specials(a)
    factor = 10.0 ** shift
    a2 = np.where(asp, a, np.round(np.where(asp, 0, a).astype(np.float64) / factor).astype(np.int64))
    return a2, b, b_exp
