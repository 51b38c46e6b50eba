"""JWT verification (reference lib/jwt): HS256/HS384/HS512 via hmac and
RS256 via pure-integer RSASSA-PKCS1-v1_5 (no external crypto deps —
the modexp + DER parsing are ~40 lines).

verify(token, secrets=[...], public_keys=[...]) -> claims dict; raises
JWTError on bad signature/format/expiry.

The port's copy of ``victoriametrics_tpu/utils/jwt.py``, whole (the
standard library only).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JWTError(ValueError):
    pass


def _b64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    try:
        return base64.urlsafe_b64decode(data + pad)
    except Exception as e:
        raise JWTError(f"bad base64url segment: {e}")


_HS = {"HS256": hashlib.sha256, "HS384": hashlib.sha384,
       "HS512": hashlib.sha512}

# DigestInfo DER prefix for SHA-256 (RFC 8017 9.2)
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def _parse_rsa_public_pem(pem: str) -> tuple[int, int]:
    """(n, e) from an SPKI 'PUBLIC KEY' or PKCS#1 'RSA PUBLIC KEY' PEM."""
    body = "".join(line for line in pem.strip().splitlines()
                   if not line.startswith("-----"))
    der = base64.b64decode(body)

    def read_tlv(b, i):
        tag = b[i]
        ln = b[i + 1]
        i += 2
        if ln & 0x80:
            k = ln & 0x7F
            ln = int.from_bytes(b[i:i + k], "big")
            i += k
        return tag, b[i:i + ln], i + ln

    tag, seq, _ = read_tlv(der, 0)
    if tag != 0x30:
        raise JWTError("bad DER: expected SEQUENCE")
    # SPKI: SEQUENCE { AlgorithmIdentifier, BIT STRING { PKCS#1 } }
    t1, first, j = read_tlv(seq, 0)
    if t1 == 0x30:  # AlgorithmIdentifier -> unwrap the BIT STRING
        t2, bits, _ = read_tlv(seq, j)
        if t2 != 0x03:
            raise JWTError("bad SPKI: expected BIT STRING")
        _, seq, _ = read_tlv(bits[1:], 0)  # skip unused-bits octet
        t1, first, j = read_tlv(seq, 0)
    if t1 != 0x02:
        raise JWTError("bad PKCS#1: expected INTEGER modulus")
    n = int.from_bytes(first, "big")
    t2, e_b, _ = read_tlv(seq, j)
    if t2 != 0x02:
        raise JWTError("bad PKCS#1: expected INTEGER exponent")
    return n, int.from_bytes(e_b, "big")


def _rs256_ok(signing_input: bytes, sig: bytes, pem: str) -> bool:
    n, e = _parse_rsa_public_pem(pem)
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    # EMSA-PKCS1-v1_5: 0x00 0x01 FF..FF 0x00 DigestInfo
    digest = hashlib.sha256(signing_input).digest()
    expected = b"\x00\x01" + b"\xff" * (k - 3 - len(_SHA256_PREFIX) -
                                        len(digest)) + b"\x00" + \
        _SHA256_PREFIX + digest
    return hmac.compare_digest(em, expected)


def verify(token: str, secrets: list[str] | None = None,
           public_keys: list[str] | None = None,
           now: float | None = None) -> dict:
    parts = token.split(".")
    if len(parts) != 3:
        raise JWTError("token must have three segments")
    try:
        header = json.loads(_b64url(parts[0]))
        claims = json.loads(_b64url(parts[1]))
    except (ValueError, UnicodeDecodeError) as e:
        raise JWTError(f"malformed token segments: {e}")
    if not isinstance(header, dict) or not isinstance(claims, dict):
        raise JWTError("token segments must be JSON objects")
    sig = _b64url(parts[2])
    signing_input = (parts[0] + "." + parts[1]).encode()
    alg = header.get("alg", "")
    ok = False
    if alg in _HS:
        for secret in secrets or []:
            want = hmac.new(secret.encode(), signing_input,
                            _HS[alg]).digest()
            if hmac.compare_digest(want, sig):
                ok = True
                break
    elif alg == "RS256":
        for pem in public_keys or []:
            try:
                if _rs256_ok(signing_input, sig, pem):
                    ok = True
                    break
            except JWTError:
                continue
    else:
        raise JWTError(f"unsupported alg {alg!r}")
    if not ok:
        raise JWTError("signature verification failed")
    # token exp/nbf claims are absolute wall-clock by spec
    t = time.time() if now is None else now  # vmt: disable=VMT001
    try:
        if "exp" in claims and t > float(claims["exp"]):
            raise JWTError("token expired")
        if "nbf" in claims and t < float(claims["nbf"]):
            raise JWTError("token not yet valid")
    except (TypeError, ValueError) as e:
        if isinstance(e, JWTError):
            raise
        raise JWTError(f"malformed exp/nbf claim: {e}")
    return claims
