"""The ctypes bindings match the CUDA sources: every ``extern "C"``
function of ``victoriametrics_tpu_torch/csrc/*.cu`` is bound in
``kernels.SIGNATURES`` under its source with the same number of
arguments, and the bindings name nothing the sources do not define.  A
mismatch would otherwise show only as a crash on the card."""

import re

import pytest

from victoriametrics_tpu_torch import kernels

_EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(vm_\w+)\s*\(([^)]*)\)',
                     re.S)


def _exports(name):
    src = (kernels.CSRC / f"{name}.cu").read_text()
    out = {}
    for fn, args in _EXTERN.findall(src):
        args = args.strip()
        out[fn] = 0 if args in ("", "void") else len(args.split(","))
    return out


def test_every_source_is_bound():
    sources = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    assert sources == sorted(kernels.SOURCES)


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_bindings_match_the_source(name):
    exported = _exports(name)
    # each library also exports its error-string helper, bound in lib()
    assert exported.pop("vm_cuda_error_string") == 1
    bound = {fn: len(args) for fn, args in kernels.SIGNATURES[name].items()}
    assert bound == exported
