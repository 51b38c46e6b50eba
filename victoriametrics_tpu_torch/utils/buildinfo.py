"""Build/identity info (reference lib/buildinfo): the version string
exported as ``vm_app_version{version=,short_version=}`` and the default
``instance=`` identity for the self-scrape plane.

The reference stamps the binary at link time; here the "build" is the
package, so the version is the package version plus the git short hash
when one is discoverable (best effort, never an error — a tarball
checkout simply reports the bare version).

The port's copy of ``victoriametrics_tpu/utils/buildinfo.py``, whole.
"""

from __future__ import annotations

import os

#: bumped with the repo's PR sequence (the closest analog of a release
#: tag for a growing reproduction)
SHORT_VERSION = "0.17.0"

_APP_NAME = "victoria-metrics-tpu"


def _git_rev() -> str:
    """Best-effort short commit hash, read straight from .git (no
    subprocess: this runs at import time on every app start)."""
    d = os.path.dirname(os.path.abspath(__file__))
    for _ in range(6):
        git = os.path.join(d, ".git")
        if os.path.isdir(git):
            try:
                with open(os.path.join(git, "HEAD")) as f:
                    head = f.read().strip()
                if head.startswith("ref:"):
                    ref = head.split(None, 1)[1]
                    with open(os.path.join(git, ref)) as f:
                        head = f.read().strip()
                return head[:12]
            except OSError:
                return ""
        d = os.path.dirname(d)
    return ""


_REV = _git_rev()


def short_version() -> str:
    return SHORT_VERSION


def version() -> str:
    """Full version string (reference buildinfo.Version shape:
    ``victoria-metrics-<version>-<rev>``)."""
    if _REV:
        return f"{_APP_NAME}-{SHORT_VERSION}-{_REV}"
    return f"{_APP_NAME}-{SHORT_VERSION}"
