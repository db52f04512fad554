"""Every ``extern "C"`` entry point in ``src/repro_torch/csrc/*.cu`` against
the ctypes table in ``repro_torch/kernels/_build.py``: the same names, each
in its source, with the same argument count and types, both ways.  A C
signature that changes without its table row would otherwise show only as
a wrong launch on a card.  Reads the sources as text: no card, no nvcc."""
import ctypes
import re

import pytest

from repro_torch.kernels import _build

_DECL = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(param: str):
    """The ctypes type a C parameter is bound with."""
    ty = param.rsplit(None, 1)[0] if "*" not in param else "*"
    return {"*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
            "int": ctypes.c_int}[ty.replace("const ", "").strip()]


def _entries() -> dict:
    """name -> (source stem, return type, ctypes argument types)."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _DECL.findall(path.read_text()):
            args = tuple(_ctype(p.strip()) for p in params.split(","))
            assert name not in found, f"{name} defined twice"
            found[name] = (path.stem, ret, args)
    return found


def test_sources_parse_into_entries():
    found = _entries()
    assert set(_build.SOURCES) == {src for src, _, _ in found.values()}
    assert all(ret == "int" for _, ret, _ in found.values())


@pytest.mark.parametrize("direction", ["source_to_table", "table_to_source"])
def test_every_entry_has_its_row(direction):
    found = _entries()
    a, b = (found, _build._ENTRY) if direction == "source_to_table" \
        else (_build._ENTRY, found)
    assert sorted(set(a) - set(b)) == []


@pytest.mark.parametrize("name", sorted(_build._ENTRY))
def test_row_matches_signature(name):
    src, argtypes = _build._ENTRY[name]
    got_src, _, got_args = _entries()[name]
    assert src == got_src
    assert len(argtypes) == len(got_args)
    assert argtypes == got_args
    assert argtypes[-1] is ctypes.c_void_p          # the stream, always last
