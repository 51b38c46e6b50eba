"""Config files (rule files, scrape configs, vmalert_tool test files,
relabeling and stream-aggregation configs) without a hard PyYAML
dependency.

PyYAML reads the file where it is installed.  Without it the file is read
as JSON, which is YAML too, so a config written as JSON loads on a machine
that lacks PyYAML.  A file that is neither raises ``ConfigError`` (a
ValueError, as PyYAML's own parse error is an Exception) naming PyYAML and
the file: a hot reload catches it and keeps the old config, and an app's
``main`` turns it into SystemExit at startup (``exit_on_error``).
"""

from __future__ import annotations

import json
from contextlib import contextmanager


class ConfigError(ValueError):
    """A config file that cannot be read without PyYAML."""


def loads(text: str, what: str = "config"):
    """The parsed document of ``text`` (None for an empty one)."""
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        return yaml.safe_load(text)
    if not text.strip():
        return None
    try:
        return json.loads(text)
    except ValueError as e:
        raise ConfigError(
            f"{what}: PyYAML is not installed and the file is not JSON "
            f"({e}); install PyYAML or write the config as JSON") from None


def load(path: str):
    """The parsed document of the file at ``path``."""
    with open(path) as f:
        return loads(f.read(), path)


@contextmanager
def exit_on_error():
    """At startup: a ConfigError ends the program with its message."""
    try:
        yield
    except ConfigError as e:
        raise SystemExit(str(e)) from None
