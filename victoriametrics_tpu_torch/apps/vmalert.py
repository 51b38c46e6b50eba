"""vmalert: alerting + recording rule engine (reference app/vmalert:
rule/group.go eval loop, rule/alerting.go state machine, notifier/,
remotewrite/, datasource/).

Groups of rules from Prometheus-compatible YAML; each group has a jittered
eval loop. Alerting rules run the pending->firing state machine, notify
Alertmanager-compatible endpoints, and export ALERTS/ALERTS_FOR_STATE
series; recording rules remote-write their results.

Run: python -m victoriametrics_tpu_torch.apps.vmalert -rule=rules.json
-datasource.url=http://HOST:8428 [-notifier.url=...] [-remoteWrite.url=...]

The port's copy of ``victoriametrics_tpu/apps/vmalert.py``; rule files
load through ``utils/configfile`` (PyYAML where it is installed, else
JSON).  ``EngineDatasource`` is what vmsingle's ``-rule`` evaluates
through: the registry's ``instant_vector``, so a rule reaches the CUDA
engine wherever the server has it attached.
"""

from __future__ import annotations

import argparse
import json
import math
import signal
import threading
import time
import urllib.parse
import urllib.request

from ..utils import configfile, fasttime, logger
from ..utils import metrics as metricslib

STATE_INACTIVE = "inactive"
STATE_PENDING = "pending"
STATE_FIRING = "firing"


class Datasource:
    """Prometheus-querying datasource (datasource/ analog)."""

    def __init__(self, url: str, timeout=30):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def query(self, expr: str, ts: float | None = None) -> list[dict]:
        params = {"query": expr}
        if ts is not None:
            params["time"] = ts
        url = f"{self.url}/api/v1/query?" + urllib.parse.urlencode(params)
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            data = json.loads(r.read())
        if data.get("status") != "success":
            raise RuntimeError(f"datasource error: {data}")
        out = []
        for item in data["data"]["result"]:
            out.append({"metric": item["metric"],
                        "value": float(item["value"][1]),
                        "ts": item["value"][0]})
        return out


class Notifier:
    """Alertmanager client (notifier/ analog)."""

    def __init__(self, url: str, timeout=10):
        self.url = url.rstrip("/")
        self.timeout = timeout
        # registry-backed, per-notifier (reference vmalert
        # vmalert_alerts_sent_total{addr=...})
        self._sent = metricslib.REGISTRY.counter(metricslib.format_name(
            "vm_vmalert_alerts_sent_total", {"addr": self.url}))
        self._errors = metricslib.REGISTRY.counter(metricslib.format_name(
            "vm_vmalert_alerts_send_errors_total", {"addr": self.url}))

    @property
    def sent(self) -> int:
        return self._sent.get()

    @property
    def errors(self) -> int:
        return self._errors.get()

    def send(self, alerts: list[dict]) -> None:
        body = json.dumps(alerts).encode()
        req = urllib.request.Request(
            self.url + "/api/v2/alerts", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                self._sent.inc(len(alerts))
        except OSError as e:
            self._errors.inc()
            logger.throttled_warnf("notifier", 10, "notifier %s: %s",
                                   self.url, e)


class RemoteWriter:
    """Writes recording results / alert state series via JSONL import."""

    def __init__(self, url: str, timeout=30):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def write(self, rows: list[tuple[dict, int, float]]) -> None:
        from ..ingest.parsers import series_to_jsonl
        lines = [series_to_jsonl(labels, [ts], [v]) for labels, ts, v in rows]
        req = urllib.request.Request(
            self.url + "/api/v1/import", data="\n".join(lines).encode(),
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except OSError as e:
            logger.throttled_warnf("rw", 10, "vmalert remote write: %s", e)


class EngineDatasource:
    """In-process datasource for rule groups colocated with a serving
    instance (vmsingle ``-rule`` / embedded tests): expressions evaluate
    through the engine's materialized-stream registry
    (``query/matstream.instant_vector``) — ONE evaluation per distinct
    (expression, timestamp) shared by every rule and counted once in
    the per-tenant cost plane, instead of one HTTP poll per rule.
    Returns the same row shape as :class:`Datasource` with the same
    value formatting (``float(fmt_value(v))``), so rule results are
    identical to the legacy poll path by construction; with
    ``VM_MATSTREAM=0`` the memo is bypassed and every rule evaluates
    itself — exactly the legacy behavior (the equality oracle)."""

    def __init__(self, api, tenant: tuple = (0, 0)):
        self.api = api          # httpapi.prometheus_api.PrometheusAPI
        self.tenant = tenant

    def query(self, expr: str, ts: float | None = None) -> list[dict]:
        ts_ms = fasttime.unix_ms() if ts is None else int(float(ts) * 1000)
        return self.api.matstreams.instant_vector(expr, ts_ms, self.tenant)


class LocalWriter:
    """RemoteWriter twin for embedded rule groups: recording results and
    alert state land directly in the colocated storage, no HTTP hop."""

    def __init__(self, api, tenant: tuple = (0, 0)):
        self.api = api
        self.tenant = tenant

    def write(self, rows: list[tuple[dict, int, float]]) -> None:
        self.api._ingest([(dict(labels), int(ts), float(v))
                          for labels, ts, v in rows], self.tenant)


def _dur_s(s, default=0.0) -> float:
    if s in (None, ""):
        return default
    from ..query.metricsql.parser import parse_duration_ms
    return parse_duration_ms(str(s))[0] / 1e3


def _template(s: str, labels: dict, value: float) -> str:
    """Minimal Go-template-ish expansion: {{ $labels.x }} and {{ $value }}."""
    import re as _re
    out = s.replace("{{ $value }}", repr(value)).replace(
        "{{$value}}", repr(value))
    def sub(m):
        return labels.get(m.group(1), "")
    out = _re.sub(r"\{\{\s*\$labels\.(\w+)\s*\}\}", sub, out)
    return out


class AlertingRule:
    def __init__(self, cfg: dict, group: "Group"):
        self.name = cfg["alert"]
        self.expr = cfg["expr"]
        self.for_s = _dur_s(cfg.get("for"), 0.0)
        self.labels = {str(k): str(v)
                       for k, v in (cfg.get("labels") or {}).items()}
        self.annotations = cfg.get("annotations") or {}
        self.group = group
        self._active: dict[tuple, dict] = {}  # labelset -> state
        self.last_error = ""

    def eval(self, ds: Datasource, now: float) -> list[dict]:
        """Returns the list of active alerts after this eval."""
        try:
            results = self.datasource_results(ds, now)
            self.last_error = ""
        except (OSError, RuntimeError, ValueError) as e:
            self.last_error = str(e)
            return list(self._active.values())
        seen = set()
        for r in results:
            labels = {**r["metric"], **self.labels,
                      "alertname": self.name}
            labels.pop("__name__", None)
            key = tuple(sorted(labels.items()))
            seen.add(key)
            st = self._active.get(key)
            if st is None:
                st = {"labels": labels, "state": STATE_PENDING,
                      "activeAt": now, "value": r["value"]}
                self._active[key] = st
            st["value"] = r["value"]
            if st["state"] == STATE_PENDING and \
                    now - st["activeAt"] >= self.for_s:
                st["state"] = STATE_FIRING
            st["annotations"] = {
                k: _template(str(v), labels, r["value"])
                for k, v in self.annotations.items()}
        for key in list(self._active):
            if key not in seen:
                del self._active[key]   # resolved
        return list(self._active.values())

    def datasource_results(self, ds: Datasource, now: float):
        return ds.query(self.expr, now)

    def restore(self, ds: Datasource, now: float, lookback_s: float):
        """Restore pending/firing state after a restart from the
        ALERTS_FOR_STATE series written by the previous instance
        (app/vmalert/rule/alerting.go Restore). Only useful for rules
        with a `for` duration."""
        if self.for_s <= 0 or self._active:
            return
        sel = "{alertname=%r" % self.name
        for k, v in sorted(self.labels.items()):
            sel += ",%s=%r" % (k, v)
        sel += "}"
        expr = f"last_over_time(ALERTS_FOR_STATE{sel}[{int(lookback_s)}s])"
        try:
            results = ds.query(expr, now)
        except (OSError, RuntimeError, ValueError) as e:
            self.last_error = f"restore: {e}"
            return
        for r in results:
            labels = dict(r["metric"])
            labels.pop("__name__", None)
            key = tuple(sorted(labels.items()))
            self._active[key] = {
                "labels": labels, "state": STATE_PENDING,
                "activeAt": float(r["value"]), "value": float("nan"),
                "annotations": {}}
            logger.infof("restored alert state %s activeAt=%s",
                         self.name, r["value"])

    def state_rows(self, now_ms: int) -> list:
        rows = []
        for st in self._active.values():
            labels = {"__name__": "ALERTS", "alertstate": st["state"],
                      **st["labels"]}
            rows.append((labels, now_ms, 1.0))
            rows.append(({"__name__": "ALERTS_FOR_STATE", **st["labels"]},
                         now_ms, st["activeAt"]))
        return rows


class RecordingRule:
    def __init__(self, cfg: dict, group: "Group"):
        self.name = cfg["record"]
        self.expr = cfg["expr"]
        self.labels = {str(k): str(v)
                       for k, v in (cfg.get("labels") or {}).items()}
        self.last_error = ""

    def eval(self, ds: Datasource, now: float) -> list:
        try:
            results = ds.query(self.expr, now)
            self.last_error = ""
        except (OSError, RuntimeError, ValueError) as e:
            self.last_error = str(e)
            return []
        rows = []
        now_ms = int(now * 1000)
        for r in results:
            labels = {**r["metric"], **self.labels, "__name__": self.name}
            if not math.isnan(r["value"]):
                rows.append((labels, now_ms, r["value"]))
        return rows


class Group:
    def __init__(self, cfg: dict, ds: Datasource, notifiers: list[Notifier],
                 rw: RemoteWriter | None, default_interval=60.0):
        self.name = cfg.get("name", "")
        self.interval = _dur_s(cfg.get("interval"), default_interval)
        self.ds = ds
        self.notifiers = notifiers
        self.rw = rw
        self.rules: list = []
        for rc in cfg.get("rules", []):
            if "alert" in rc:
                self.rules.append(AlertingRule(rc, self))
            elif "record" in rc:
                self.rules.append(RecordingRule(rc, self))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.last_eval = 0.0

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        import random
        if self._stop.wait(random.random() * self.interval):
            return
        while True:
            t0 = fasttime.unix_seconds()
            try:
                self.eval_once(t0)
            except Exception as e:  # pragma: no cover
                logger.errorf("group %s eval: %s", self.name, e)
            if self._stop.wait(max(self.interval -
                                   (fasttime.unix_seconds() - t0), 0.1)):
                return

    def restore(self, ds: Datasource, lookback_s: float = 86_400.0):
        now = fasttime.unix_seconds()
        for rule in self.rules:
            if isinstance(rule, AlertingRule):
                rule.restore(ds, now, lookback_s)

    def eval_once(self, now: float, notify: bool = True) -> None:
        self.last_eval = now
        now_ms = int(now * 1000)
        state_rows = []
        firing = []
        for rule in self.rules:
            if isinstance(rule, AlertingRule):
                active = rule.eval(self.ds, now)
                state_rows.extend(rule.state_rows(now_ms))
                for st in active:
                    if st["state"] == STATE_FIRING:
                        firing.append({
                            "labels": st["labels"],
                            "annotations": st.get("annotations", {}),
                            "startsAt": time.strftime(
                                "%Y-%m-%dT%H:%M:%SZ",
                                time.gmtime(st["activeAt"])),
                            "generatorURL": "",
                        })
            else:
                state_rows.extend(rule.eval(self.ds, now))
        if firing and notify:
            for n in self.notifiers:
                n.send(firing)
        if state_rows and self.rw is not None:
            self.rw.write(state_rows)

    def api_dict(self) -> dict:
        rules = []
        for r in self.rules:
            if isinstance(r, AlertingRule):
                rules.append({
                    "name": r.name, "query": r.expr, "type": "alerting",
                    "duration": r.for_s, "labels": r.labels,
                    "annotations": r.annotations,
                    "lastError": r.last_error,
                    "state": ("firing" if any(
                        s["state"] == STATE_FIRING
                        for s in r._active.values()) else
                        "pending" if r._active else "inactive"),
                    "alerts": [
                        {"labels": s["labels"], "state": s["state"],
                         "value": str(s["value"]),
                         "annotations": s.get("annotations", {})}
                        for s in r._active.values()],
                })
            else:
                rules.append({"name": r.name, "query": r.expr,
                              "type": "recording", "labels": r.labels,
                              "lastError": r.last_error})
        return {"name": self.name, "interval": self.interval, "rules": rules}


def replay(groups: list, time_from_ms: int, time_to_ms: int) -> int:
    """Replay mode (app/vmalert/replay.go): walk each group's rules over
    the historical range at the group interval, remote-writing recording
    results and alert state; notifications are suppressed. Returns the
    number of evaluations performed."""
    evals = 0
    for g in groups:
        step_ms = int(g.interval * 1000)
        t = time_from_ms
        while t <= time_to_ms:
            g.eval_once(t / 1000.0, notify=False)
            evals += 1
            t += step_ms
        logger.infof("replay: group %s evaluated %d steps", g.name,
                     (time_to_ms - time_from_ms) // step_ms + 1)
    return evals


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vmalert")
    p.add_argument("-rule", action="append", default=[],
                   help="rule file path, repeatable")
    p.add_argument("-datasource.url", dest="datasource_url",
                   default="http://127.0.0.1:8428")
    p.add_argument("-notifier.url", dest="notifier_urls", action="append",
                   default=[])
    p.add_argument("-remoteWrite.url", dest="remote_write_url", default="")
    p.add_argument("-evaluationInterval", dest="eval_interval", default="1m")
    p.add_argument("-remoteRead.url", dest="remote_read_url", default="",
                   help="restore alert state from this datasource on start")
    p.add_argument("-replay.timeFrom", dest="replay_from", default="",
                   help="replay mode: evaluate rules from this time")
    p.add_argument("-replay.timeTo", dest="replay_to", default="")
    p.add_argument("-httpListenAddr", default=":8880")
    p.add_argument("-loggerLevel", default="INFO")
    args, _ = p.parse_known_args(argv)
    return args


def build(args):
    from ..httpapi.server import HTTPServer, Response

    ds = Datasource(args.datasource_url)
    notifiers = [Notifier(u) for u in args.notifier_urls]
    rw = RemoteWriter(args.remote_write_url) if args.remote_write_url else None
    groups: list[Group] = []
    for path in args.rule:
        cfg = configfile.load(path) or {}
        for g in cfg.get("groups", []):
            groups.append(Group(g, ds, notifiers, rw,
                                _dur_s(args.eval_interval, 60.0)))

    hh, _, hp = args.httpListenAddr.rpartition(":")
    srv = HTTPServer(hh or "0.0.0.0", int(hp))
    srv.route("/health", lambda req: Response.text("OK"))
    srv.route("/api/v1/rules", lambda req: Response.json(
        {"status": "success",
         "data": {"groups": [g.api_dict() for g in groups]}}))

    def h_alerts(req):
        alerts = []
        for g in groups:
            for r in g.rules:
                if isinstance(r, AlertingRule):
                    for s in r._active.values():
                        alerts.append({"labels": s["labels"],
                                       "state": s["state"],
                                       "value": str(s["value"]),
                                       "annotations": s.get("annotations", {}),
                                       "activeAt": s["activeAt"]})
        return Response.json({"status": "success",
                              "data": {"alerts": alerts}})

    srv.route("/api/v1/alerts", h_alerts)
    return groups, srv


def main(argv=None):
    import faulthandler
    faulthandler.register(signal.SIGUSR1)
    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    with configfile.exit_on_error():
        groups, srv = build(args)
    if args.replay_from and args.replay_to:
        from ..httpapi.prometheus_api import parse_time
        frm = parse_time(args.replay_from, 0)
        to = parse_time(args.replay_to, 0)
        n = replay(groups, frm, to)
        logger.infof("vmalert replay finished: %d evaluations", n)
        return
    if args.remote_read_url:
        rr = Datasource(args.remote_read_url)
        for g in groups:
            g.restore(rr)
    stop = threading.Event()
    # the handlers are in place before anything is served
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    for g in groups:
        g.start()
    srv.start()
    logger.infof("vmalert started: groups=%d http=%d", len(groups), srv.port)
    try:
        while not stop.wait(1.0):
            pass
    finally:
        for g in groups:
            g.stop()
        srv.stop()
        logger.infof("vmalert: shutdown complete")


if __name__ == "__main__":
    main()
