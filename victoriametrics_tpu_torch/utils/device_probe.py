"""Bounded-timeout accelerator probe for the CUDA engine.

The port's counterpart of ``victoriametrics_tpu/utils/tpu_probe.py``, with
the same API (``ProbeResult``, ``start_probe()``, ``probe_backend(timeout)``)
and the same shape: initializing the accelerator IN-PROCESS is not
cancellable (a wedged device init blocks the first CUDA call forever and takes
the whole server with it), so the probe pays a subprocess to find out
whether the card comes up, with a hard deadline; only on success do
callers initialize CUDA in-process.

The probe subprocess imports ``torch`` and reports
``torch.cuda.device_count()`` and the first device's name (``platform``
``"cuda"``); no device is a failure.  It arms
``faulthandler.dump_traceback_later`` so that when it hangs past the
deadline, the captured stderr carries periodic stack dumps — the returned
``stack`` pinpoints WHERE the init died.

``start_probe()`` returns immediately with a handle so callers can overlap
the probe with other startup work; ``probe_backend()`` is the blocking
wrapper.  Used by the port's vmsingle ``-search.tpuBackend`` startup.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Dump the probe's stacks every 45s while it is stuck; the LAST dump in
# stderr is what the caller reports.
_DUMP_INTERVAL_S = 45

_PROBE_CODE = """\
import faulthandler, json, sys
faulthandler.dump_traceback_later({dump}, repeat=True, file=sys.stderr)
import torch
n = torch.cuda.device_count() if torch.cuda.is_available() else 0
if n == 0:
    sys.exit('no CUDA device visible (torch.cuda.device_count() == 0)')
name = torch.cuda.get_device_name(0)
faulthandler.cancel_dump_traceback_later()
print('PROBE:' + json.dumps({{'platform': 'cuda', 'n': n, 'name': name}}))
"""


class ProbeResult:
    """Outcome of an accelerator probe.

    platform: "cuda", or None on failure
    n: device count (0 on failure)
    name: the first device's name (None on failure)
    error: human-readable failure reason, None on success
    stack: last faulthandler stack dump from a hung probe (None unless the
           probe timed out and produced one) — the where-it-died artifact
    elapsed_s: how long the probe took
    """

    __slots__ = ("platform", "n", "error", "stack", "elapsed_s", "name")

    def __init__(self, platform, n, error, stack=None, elapsed_s=0.0,
                 name=None):
        self.platform = platform
        self.n = n
        self.name = name
        self.error = error
        self.stack = stack
        self.elapsed_s = elapsed_s

    def __iter__(self):  # legacy (platform, n, error) unpacking
        return iter((self.platform, self.n, self.error))


def _last_stack_dump(stderr: str):
    """Extract the last faulthandler dump from captured stderr.

    faulthandler emits blocks starting "Timeout (H:MM:SS)!"; keep the text
    from the final such marker, trimmed to a sane size."""
    if not stderr:
        return None
    idx = stderr.rfind("Timeout (")
    if idx < 0:
        return None
    return stderr[idx:idx + 4000].strip()


class ProbeHandle:
    """In-flight accelerator probe; `result()` blocks until done/deadline.

    The child's stdout/stderr go to TEMP FILES, not pipes: the caller may
    not call result() for minutes (bench overlaps the probe with ingest),
    and a chatty backend init writing >64KB into an undrained pipe would
    block mid-init — misdiagnosing a healthy device as hung."""

    def __init__(self, proc: subprocess.Popen, timeout_s: float,
                 out_f, err_f):
        self._proc = proc
        self._timeout_s = timeout_s
        self._t0 = time.monotonic()
        self._result = None
        self._out_f = out_f
        self._err_f = err_f

    def _read_files(self):
        out = err = ""
        for attr, f in (("out", self._out_f), ("err", self._err_f)):
            try:
                f.seek(0)
                data = f.read()
                f.close()
            except (OSError, ValueError):
                data = ""
            if attr == "out":
                out = data
            else:
                err = data
        return out, err

    def cancel(self) -> None:
        """Kill the probe child if still running (callers' error paths:
        a hung child must not outlive its parent holding the device)."""
        if self._result is None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
            self._read_files()

    def result(self) -> ProbeResult:
        if self._result is not None:
            return self._result
        remaining = max(0.0, self._timeout_s -
                        (time.monotonic() - self._t0))
        try:
            self._proc.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
            _, err = self._read_files()
            self._result = ProbeResult(
                None, 0,
                f"accelerator probe timed out after {self._timeout_s:g}s "
                "(hung backend init?)",
                stack=_last_stack_dump(err or ""),
                elapsed_s=time.monotonic() - self._t0)
            return self._result
        elapsed = time.monotonic() - self._t0
        out, err = self._read_files()
        if self._proc.returncode != 0:
            tail = (err or "").strip().splitlines()[-3:]
            self._result = ProbeResult(
                None, 0, "accelerator probe failed: " +
                (" | ".join(tail) or f"rc={self._proc.returncode}"),
                elapsed_s=elapsed)
            return self._result
        for line in (out or "").splitlines():
            if line.startswith("PROBE:"):
                info = json.loads(line[len("PROBE:"):])
                self._result = ProbeResult(info["platform"], int(info["n"]),
                                           None, elapsed_s=elapsed,
                                           name=info.get("name"))
                return self._result
        self._result = ProbeResult(None, 0,
                                   "accelerator probe produced no result",
                                   elapsed_s=elapsed)
        return self._result


def start_probe(timeout_s: float = 600.0) -> ProbeHandle:
    """Launch the probe subprocess; returns immediately."""
    import tempfile
    code = _PROBE_CODE.format(dump=_DUMP_INTERVAL_S)
    try:
        out_f = tempfile.TemporaryFile(mode="w+", prefix="vmcuda-probe-out")
        err_f = tempfile.TemporaryFile(mode="w+", prefix="vmcuda-probe-err")
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=out_f, stderr=err_f, text=True,
                                env=os.environ.copy())
    except OSError as e:
        class _Failed:
            def result(self, _e=e):
                return ProbeResult(None, 0,
                                   f"accelerator probe could not run: {_e}")

            def cancel(self):
                pass
        return _Failed()
    return ProbeHandle(proc, timeout_s, out_f, err_f)


def probe_backend(timeout_s: float = 600.0):
    """Blocking probe. Returns a ProbeResult, which also unpacks as
    (platform, n_devices, error) — platform is "cuda" (None when the
    probe failed), error is a human-readable reason on failure (None on
    success)."""
    return start_probe(timeout_s).result()
