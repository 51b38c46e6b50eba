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


def test_the_mesh_and_fused_decode_entry_points_are_bound():
    # B12 (rollup.cu), B13's moments pass (rollup.cu: K2's group pass
    # with moments = 1), B15's passes over a card's time shards
    # (rollup.cu) and the mesh layer's combine and halo pass (mesh.cu;
    # B15's add-back is in its series pass's store)
    assert {"vm_decode_rollup_plan", "vm_decode_rollup", "vm_rollup_groups",
            "vm_time_shards_scan", "vm_time_shards_prep",
            "vm_time_shards_series"} <= set(kernels.SIGNATURES["rollup"])
    assert set(kernels.SIGNATURES["mesh"]) == {
        "vm_combine_moments", "vm_halo_compact"}
    # B15 writes a time shard's block of a wider output: B5 takes a row
    # stride, then its plan (staged, rows, steps, cap: b5_plan)
    assert len(kernels.SIGNATURES["rollup"]["vm_rollup_series"]) == 24


def test_b6_is_one_entry_point_with_its_plan():
    # B6 takes the wrapper's plan (topk_plan) in one call; take_rows names
    # its index type
    assert set(kernels.SIGNATURES["select"]) == {
        "vm_topk_select", "vm_take_rows", "vm_rank_rows"}
    assert len(kernels.SIGNATURES["select"]["vm_topk_select"]) == 14
    assert len(kernels.SIGNATURES["select"]["vm_take_rows"]) == 8


def test_k1_is_one_entry_point_and_the_append_takes_its_lanes():
    # K1 decodes both planes in one launch with its plan's chunk and
    # workspace (k1_plan); K3 and B10 share one kernel whose lanes a row
    # follow K (append_plan)
    assert set(kernels.SIGNATURES["decode"]) == {"vm_decode_tiles"}
    assert len(kernels.SIGNATURES["decode"]["vm_decode_tiles"]) == 19
    assert len(kernels.SIGNATURES["tile"]["vm_append_tile"]) == 11
    assert len(kernels.SIGNATURES["tile"]["vm_fleet_append_tile"]) == 12
