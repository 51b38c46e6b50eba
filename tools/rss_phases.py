#!/usr/bin/env python3
"""Run a command and report its peak host memory (resident set) per phase.

    python3 tools/rss_phases.py [--interval S] [--out FILE] -- CMD [ARG...]

CMD's standard output is passed through line by line.  A line that is a
JSON object with a "phase" key ends a phase (chip_smoke.py prints one at
the end of each).  Meanwhile a thread reads the process's VmRSS from
/proc/<pid>/status every --interval seconds (default 0.02).  For each
phase the peak sample since the previous phase line is kept (memory still
held from earlier phases counts), with the process's VmHWM (its lifetime
peak) when the line was read.  A phase whose VmHWM rose during it peaked
at exactly that VmHWM; otherwise its peak is the sampled one, which can
miss a spike shorter than the interval.  Where /proc gives no VmHWM
(not every kernel provides it), vm_hwm_bytes is null and only samples
count.

At the end it prints one JSON line, {"rss_phases": [{"phase", "peak_rss_bytes",
"vm_hwm_bytes", "hwm_rose"}, ...], "exit_code": N}, also written to --out,
and exits with CMD's exit code.  Only CMD's own process is read, not the
compilers it starts.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading


def _status_kb(pid: int, key: str) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--interval", type=float, default=0.02)
    ap.add_argument("--out", help="also write the summary line here")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            bufsize=1)
    lock = threading.Lock()
    peak = [0]
    done = threading.Event()

    def sample():
        while not done.wait(args.interval):
            kb = _status_kb(proc.pid, "VmRSS")
            with lock:
                peak[0] = max(peak[0], kb)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    phases, hwm_before = [], 0
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if not isinstance(obj, dict) or "phase" not in obj:
            continue
        hwm = _status_kb(proc.pid, "VmHWM")
        with lock:
            rss, peak[0] = peak[0], _status_kb(proc.pid, "VmRSS")
        phases.append({"phase": obj["phase"],
                       "peak_rss_bytes": max(rss, hwm if hwm > hwm_before
                                             else 0) * 1024,
                       "vm_hwm_bytes": hwm * 1024 if hwm else None,
                       "hwm_rose": hwm > hwm_before})
        hwm_before = max(hwm_before, hwm)
    rc = proc.wait()
    done.set()
    sampler.join()
    summary = json.dumps({"rss_phases": phases, "exit_code": rc})
    print(summary, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(summary + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
