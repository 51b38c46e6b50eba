"""Series identity: metric name + sorted labels with canonical byte
marshaling (reference lib/storage/metric_name.go:75,137).

The canonical form is an escaped, separator-delimited byte string so that
(a) equal series marshal identically, (b) prefix scans over the index work
(escaping preserves prefixes, unlike length-prefixing), and (c) the metric
group (the __name__ value) is a leading prefix, clustering families.

Layout: esc(name) 0x00 esc(k1) 0x01 esc(v1) 0x00 esc(k2) 0x01 esc(v2) ...
with labels sorted by key. Escapes: 0x00->0x02 0x03, 0x01->0x02 0x04,
0x02->0x02 0x05.

The port's copy of ``victoriametrics_tpu/storage/metric_name.py``, whole.
"""

from __future__ import annotations

import re

SEP_TAG = b"\x00"
SEP_KV = b"\x01"
_ESC = b"\x02"

_ESC_MAP = {0x00: b"\x02\x03", 0x01: b"\x02\x04", 0x02: b"\x02\x05"}
_UNESC_MAP = {0x03: 0x00, 0x04: 0x01, 0x05: 0x02}
# one C-level scan for the (overwhelmingly common) nothing-to-escape case
_NEEDS_ESC = re.compile(rb"[\x00-\x02]")


def escape(b: bytes) -> bytes:
    if _NEEDS_ESC.search(b) is None:
        return b
    out = bytearray()
    for c in b:
        if c <= 0x02:
            out += _ESC_MAP[c]
        else:
            out.append(c)
    return bytes(out)


def unescape(b: bytes) -> bytes:
    if _ESC not in b:
        return b
    out = bytearray()
    i = 0
    while i < len(b):
        c = b[i]
        if c == 0x02:
            i += 1
            if i >= len(b) or b[i] not in _UNESC_MAP:
                raise ValueError("bad escape sequence in metric name")
            out.append(_UNESC_MAP[b[i]])
        else:
            out.append(c)
        i += 1
    return bytes(out)


class MetricName:
    """A metric group name plus sorted (key, value) labels.

    `labels` never contains __name__ — that is `metric_group`. Empty label
    values are dropped (Prometheus semantics: empty value == absent label).
    """

    __slots__ = ("metric_group", "labels")

    def __init__(self, metric_group: bytes = b"", labels=None):
        self.metric_group = metric_group
        self.labels: list[tuple[bytes, bytes]] = labels or []

    @classmethod
    def from_labels(cls, pairs) -> "MetricName":
        """Build from an iterable of (name, value) in any order; accepts str
        or bytes; drops empties; extracts __name__."""
        group = b""
        labels = []
        for k, v in pairs:
            kb = k.encode() if isinstance(k, str) else k
            vb = v.encode() if isinstance(v, str) else v
            if not vb:
                continue
            if kb == b"__name__":
                group = vb
            else:
                labels.append((kb, vb))
        labels.sort()
        return cls(group, labels)

    @classmethod
    def from_dict(cls, d) -> "MetricName":
        return cls.from_labels(d.items())

    def to_dict(self) -> dict[str, str]:
        out = {}
        if self.metric_group:
            out["__name__"] = self.metric_group.decode()
        for k, v in self.labels:
            out[k.decode()] = v.decode()
        return out

    def sort_labels(self) -> None:
        self.labels.sort()

    def get_label(self, key: bytes) -> bytes | None:
        if key == b"__name__":
            return self.metric_group or None
        for k, v in self.labels:
            if k == key:
                return v
        return None

    def marshal(self) -> bytes:
        parts = [escape(self.metric_group)]
        for k, v in self.labels:
            parts.append(SEP_TAG + escape(k) + SEP_KV + escape(v))
        return b"".join(parts)

    @classmethod
    def unmarshal(cls, data: bytes) -> "MetricName":
        chunks = data.split(SEP_TAG)
        mn = cls(unescape(chunks[0]))
        for c in chunks[1:]:
            k, _, v = c.partition(SEP_KV)
            mn.labels.append((unescape(k), unescape(v)))
        return mn

    def __eq__(self, other):
        return (self.metric_group == other.metric_group
                and self.labels == other.labels)

    def __hash__(self):
        return hash((self.metric_group, tuple(self.labels)))

    def __repr__(self):
        lbl = ", ".join(f"{k.decode()}={v.decode()!r}" for k, v in self.labels)
        return f"{self.metric_group.decode()}{{{lbl}}}"
