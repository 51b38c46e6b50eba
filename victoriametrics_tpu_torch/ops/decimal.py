"""Decimal codec, float64[] -> (int64 mantissas, common decimal exponent).

The port's own copy of the encode half of ``victoriametrics_tpu/ops/
decimal.py`` (``float_to_decimal`` and the special-value sentinels it
needs; reference lib/decimal/decimal.go AppendFloatToDecimal): the cold
upload turns each series' float64 values into integer mantissas before
packing nearest-delta2 planes.  Host numpy only, bit-identical to the
reference module, which the tests hold it against.

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
