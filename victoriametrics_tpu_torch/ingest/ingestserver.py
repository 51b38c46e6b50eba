"""TCP/UDP ingestion listeners (reference lib/ingestserver/{graphite,influx,
opentsdb}/server.go): line-protocol servers for Graphite plaintext, Influx
line protocol and OpenTSDB telnet `put`, each accepting both TCP streams and
UDP datagrams.

The port's copy of ``victoriametrics_tpu/ingest/ingestserver.py``, whole.
"""

from __future__ import annotations

import socket
import socketserver
import threading

from ..utils import logger
from . import parsers

PARSERS = {
    "graphite": parsers.parse_graphite,
    "influx": parsers.parse_influx,
    "opentsdb": parsers.parse_opentsdb_telnet,
}


class IngestServer:
    """One protocol listener on TCP + UDP sharing a port."""

    MAX_LINE = 64 << 10

    def __init__(self, proto: str, addr: str, port: int, ingest_rows_fn):
        """ingest_rows_fn receives an iterator of parsers.Row (so the shared
        ingestion tail applies timestamp defaulting / relabeling)."""
        if proto not in PARSERS:
            raise ValueError(f"unknown ingest protocol {proto!r}")
        parse = PARSERS[proto]
        self.proto = proto
        max_line = self.MAX_LINE

        def ingest_text(text: str):
            ingest_rows_fn(parse(text))

        class TCPHandler(socketserver.StreamRequestHandler):
            def handle(self):
                buf = []
                while True:
                    # bounded reads: a newline-less stream must not buffer
                    # unboundedly in RAM; oversized lines get dropped by the
                    # parser as garbage
                    line = self.rfile.readline(max_line)
                    if not line:
                        break
                    buf.append(line.decode("utf-8", "replace"))
                    if len(buf) >= 500:
                        ingest_text("".join(buf))
                        buf = []
                if buf:
                    ingest_text("".join(buf))

        class UDPHandler(socketserver.BaseRequestHandler):
            def handle(self):
                data = self.request[0]
                ingest_text(data.decode("utf-8", "replace"))

        class TCP(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        class UDP(socketserver.ThreadingUDPServer):
            daemon_threads = True
            allow_reuse_address = True
            max_packet_size = 64 * 1024  # default 8KB truncates batched lines

        self._tcp = TCP((addr, port), TCPHandler)
        self.port = self._tcp.server_address[1]
        self._udp = UDP((addr, self.port), UDPHandler)
        # long-lived TCP/UDP accept loops, one each — not fan-out work
        self._threads = [
            threading.Thread(target=self._tcp.serve_forever,  # vmt: disable=VMT011
                             daemon=True),
            threading.Thread(target=self._udp.serve_forever,  # vmt: disable=VMT011
                             daemon=True),
        ]

    def start(self):
        for t in self._threads:
            t.start()
        logger.infof("%s ingest server listening on tcp+udp :%d",
                     self.proto, self.port)

    def stop(self):
        self._tcp.shutdown()
        self._tcp.server_close()
        self._udp.shutdown()
        self._udp.server_close()
