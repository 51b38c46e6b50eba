"""Field declarations of the race sanitizer.

The port's copy of ``victoriametrics_tpu/devtools/racetrace.py`` as far as
the storage uses it: ``traced_fields`` returns the class unchanged, as the
reference does while the sanitizer is off.  The happens-before sanitizer
(``VMT_RACETRACE=1``) comes with the tooling item of the roadmap.
"""

from __future__ import annotations


def traced_fields(*names: str):
    """Class decorator declaring which mutable fields the sanitizer
    observes; a no-op here."""
    del names

    def deco(cls):
        return cls

    return deco
