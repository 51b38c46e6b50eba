"""vmctl: data migration CLI (reference app/vmctl): modes

  vm-native   copy series between instances via /api/v1/export + import
  prometheus  import a Prometheus text/OpenMetrics dump file
  influx      import an InfluxDB line-protocol file
  opentsdb    import an OpenTSDB telnet-format file

with interval chunking and selector filtering, plus remote-read
migration, Prometheus TSDB blocks (prometheus-tsdb) and verify-block.

Run: python -m victoriametrics_tpu_torch.apps.vmctl vm-native
--vm-native-src-addr=http://SRC:8428 --vm-native-dst-addr=http://DST:8428
[--vm-native-filter-match=... --vm-native-filter-time-start=...]

The port's copy of ``victoriametrics_tpu/apps/vmctl.py``, whole.
"""

from __future__ import annotations

import argparse
import sys
import urllib.parse
import urllib.request

from ..utils import logger


def _post(url: str, data: bytes, timeout=120) -> None:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        r.read()


def vm_native(src: str, dst: str, match: str, start: str = "", end: str = "",
              chunk_rows: int = 10_000) -> int:
    """Stream JSONL export from src into dst."""
    params = {"match[]": match}
    if start:
        params["start"] = start
    if end:
        params["end"] = end
    url = src.rstrip("/") + "/api/v1/export?" + urllib.parse.urlencode(params)
    total = 0
    buf: list[bytes] = []
    with urllib.request.urlopen(url, timeout=300) as r:
        for line in r:
            line = line.strip()
            if not line:
                continue
            buf.append(line)
            total += 1
            if len(buf) >= chunk_rows:
                _post(dst.rstrip("/") + "/api/v1/import", b"\n".join(buf))
                buf = []
    if buf:
        _post(dst.rstrip("/") + "/api/v1/import", b"\n".join(buf))
    logger.infof("vmctl vm-native: migrated %d series chunks", total)
    return total


def remote_read(src: str, dst: str, match: str, start_ms: int,
                end_ms: int, chunk_rows: int = 50_000) -> int:
    """Migrate from any Prometheus remote_read endpoint (prometheus, mimir,
    thanos — the reference vmctl's remote-read mode) into dst."""
    import json as _json
    import re as _re

    from ..ingest import remote_write as rw
    from ..ingest.parsers import series_to_jsonl
    matchers = []
    m = _re.match(r"\{(.*)\}$", match.strip()) if match.strip().startswith("{") else None
    body_expr = m.group(1) if m else ""
    if body_expr or m:
        for mm in _re.finditer(
                r'([A-Za-z_][\w]*)\s*(=~|!~|!=|=)\s*"((?:[^"\\]|\\.)*)"',
                body_expr):
            matchers.append((mm.group(2), mm.group(1),
                             mm.group(3).replace('\\"', '"')))
        if not matchers:
            raise ValueError(f"cannot parse matchers in {match!r}")
    else:
        matchers.append(("=", "__name__", match.strip()))
    body = rw.build_read_request(start_ms, end_ms, matchers)
    req = urllib.request.Request(
        src.rstrip("/") + "/api/v1/read", data=body, method="POST",
        headers={"Content-Encoding": "snappy",
                 "Content-Type": "application/x-protobuf",
                 "X-Prometheus-Remote-Read-Version": "0.1.0"})
    with urllib.request.urlopen(req, timeout=300) as r:
        resp = r.read()
    total = 0
    _flushed = {"n": 0}
    buf: list[bytes] = []
    for labels, samples in rw.parse_read_response(resp):
        if not samples:
            continue
        d = {k.decode() if isinstance(k, bytes) else k:
             v.decode() if isinstance(v, bytes) else v
             for k, v in labels}
        buf.append(series_to_jsonl(d, [t for t, _ in samples],
                                   [v for _, v in samples]).encode())
        total += len(samples)
        if total - _flushed["n"] >= max(chunk_rows, 1):
            _post(dst.rstrip("/") + "/api/v1/import", b"\n".join(buf))
            _flushed["n"] = total
            buf = []
    if buf:
        _post(dst.rstrip("/") + "/api/v1/import", b"\n".join(buf))
    logger.infof("vmctl remote-read: migrated %d samples", total)
    return total


def import_file(path: str, dst: str, fmt: str, chunk_lines: int = 50_000) -> int:
    endpoint = {"prometheus": "/api/v1/import/prometheus",
                "influx": "/write",
                "opentsdb": None}[fmt]
    total = 0
    if fmt == "opentsdb":
        # convert telnet puts -> prometheus text
        from ..ingest.parsers import parse_opentsdb_telnet
        lines = []
        for row in parse_opentsdb_telnet(open(path).read()):
            labels = dict(row.labels)
            name = labels.pop("__name__")
            lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            lines.append(f"{name}{{{lab}}} {row.value} {row.timestamp}")
            total += 1
        _post(dst.rstrip("/") + "/api/v1/import/prometheus",
              "\n".join(lines).encode())
        return total
    buf: list[str] = []
    for line in open(path):
        if not line.strip():
            continue
        buf.append(line.rstrip("\n"))
        total += 1
        if len(buf) >= chunk_lines:
            _post(dst.rstrip("/") + endpoint, "\n".join(buf).encode())
            buf = []
    if buf:
        _post(dst.rstrip("/") + endpoint, "\n".join(buf).encode())
    logger.infof("vmctl %s: imported %d lines", fmt, total)
    return total


def _esc_label(v: str) -> str:
    """Prometheus text-format label value escaping."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_tsdb(path: str, dst: str, chunk_lines: int = 50_000) -> int:
    """Migrate a Prometheus TSDB data dir (or one block dir) into dst —
    the reference vmctl `prometheus` snapshot mode (app/vmctl/main.go:259
    via prometheus/tsdb). Reads the binary block format directly
    (utils/promtsdb: index + XOR chunks) and streams prometheus text."""
    import os

    from ..utils.promtsdb import read_block
    if os.path.exists(os.path.join(path, "index")):
        blocks = [path]
    else:
        blocks = sorted(
            os.path.join(path, d) for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d)) and
            os.path.exists(os.path.join(path, d, "index")))
    if not blocks:
        raise SystemExit(f"vmctl prometheus-tsdb: no blocks under {path}")
    total = 0
    skipped = [0]
    buf: list[str] = []

    def on_unsupported(labels, err):
        skipped[0] += 1
        logger.errorf("vmctl prometheus-tsdb: skipping series %s: %s",
                      labels.get("__name__", "?"), err)
    for bdir in blocks:
        logger.infof("vmctl prometheus-tsdb: reading block %s", bdir)
        from ..query.format_value import fmt_value
        for labels, ts, vals in read_block(bdir,
                                           on_unsupported=on_unsupported):
            name = labels.get("__name__", "")
            if not name:
                continue
            rest = ",".join(f'{k}="{_esc_label(v)}"'
                            for k, v in sorted(labels.items())
                            if k != "__name__")
            head = f"{name}{{{rest}}}" if rest else name
            for t, v in zip(ts.tolist(), vals.tolist()):
                buf.append(f"{head} {fmt_value(v)} {t}")
                total += 1
                if len(buf) >= chunk_lines:
                    _post(dst.rstrip("/") + "/api/v1/import/prometheus",
                          "\n".join(buf).encode())
                    buf = []
    if buf:
        _post(dst.rstrip("/") + "/api/v1/import/prometheus",
              "\n".join(buf).encode())
    logger.infof("vmctl prometheus-tsdb: migrated %d samples from %d "
                 "block(s); %d series skipped (unsupported chunk "
                 "encodings)", total, len(blocks), skipped[0])
    return total


def verify_block_cmd(path: str) -> int:
    """vmctl verify-block (app/vmctl/main.go:514): walk one TSDB block's
    structures + CRCs, print the report, exit nonzero on problems."""
    import json as _json

    from ..utils.promtsdb import verify_block
    rep = verify_block(path)
    try:
        print(_json.dumps(rep, indent=1))
    except BrokenPipeError:  # e.g. piped into head
        pass
    return 0 if rep["ok"] else 1


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    p = argparse.ArgumentParser(prog="vmctl")
    sub = p.add_subparsers(dest="mode", required=True)

    pn = sub.add_parser("vm-native")
    pn.add_argument("--vm-native-src-addr", required=True)
    pn.add_argument("--vm-native-dst-addr", required=True)
    pn.add_argument("--vm-native-filter-match", default='{__name__=~".*"}')
    pn.add_argument("--vm-native-filter-time-start", default="")
    pn.add_argument("--vm-native-filter-time-end", default="")

    for fmt in ("prometheus", "influx", "opentsdb"):
        pf = sub.add_parser(fmt)
        pf.add_argument("--file", required=True)
        pf.add_argument("--dst-addr", required=True)

    pt = sub.add_parser("prometheus-tsdb",
                        help="migrate Prometheus TSDB blocks (binary "
                             "snapshot format)")
    pt.add_argument("--tsdb-path", required=True,
                    help="a data dir of blocks, or one block dir")
    pt.add_argument("--dst-addr", required=True)

    pv = sub.add_parser("verify-block",
                        help="validate one TSDB block's structure + CRCs")
    pv.add_argument("--block-path", required=True)

    args = p.parse_args(argv)
    if args.mode == "vm-native":
        vm_native(args.vm_native_src_addr, args.vm_native_dst_addr,
                  args.vm_native_filter_match,
                  args.vm_native_filter_time_start,
                  args.vm_native_filter_time_end)
    elif args.mode == "prometheus-tsdb":
        prometheus_tsdb(args.tsdb_path, args.dst_addr)
    elif args.mode == "verify-block":
        raise SystemExit(verify_block_cmd(args.block_path))
    else:
        import_file(args.file, args.dst_addr, args.mode)


if __name__ == "__main__":
    main()
