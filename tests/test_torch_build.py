"""The port's kernel build (dinomc_tpu_torch/ops/hopper/_build.py), without
nvcc: which files feed the library's hash and which are compiled."""

from pathlib import Path

from dinomc_tpu_torch.ops.hopper import _build


def _csrc(tmp_path: Path) -> Path:
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "a.cu").write_text('#include "tiles.cuh"\n')
    (d / "b.cu").write_text("// b\n")
    (d / "tiles.cuh").write_text("// shared device code\n")
    return d


def test_header_edit_changes_the_library_hash(tmp_path, monkeypatch):
    d = _csrc(tmp_path)
    monkeypatch.setattr(_build, "CSRC_DIR", d)
    before = _build.library_path()
    (d / "tiles.cuh").write_text("// shared device code, edited\n")
    after = _build.library_path()
    assert before != after
    (d / "b.cu").write_text("// b, edited\n")
    assert _build.library_path() not in (before, after)


def test_headers_are_never_compiled_on_their_own(tmp_path, monkeypatch):
    d = _csrc(tmp_path)
    monkeypatch.setattr(_build, "CSRC_DIR", d)
    obj = tmp_path / "obj"
    cmds = _build.compile_commands("nvcc", obj)
    assert [c[c.index("-c") + 1] for c in cmds] == [str(d / "a.cu"), str(d / "b.cu")]
    link = _build.link_command("nvcc", obj, tmp_path / "lib.so")
    assert link[-2:] == [str(obj / "a.o"), str(obj / "b.o")] and "-shared" in link
    for cmd in cmds + [link]:
        assert not any(arg.endswith(".cuh") for arg in cmd), cmd


def test_every_entry_point_has_a_signature():
    sources = "".join(p.read_text() for p in sorted(_build.CSRC_DIR.glob("*.cu")))
    for name in _build._SIGNATURES:
        assert f'extern "C" int {name}(' in sources, name


def test_signatures_match_the_c_parameters():
    """Each ctypes signature has the C entry point's parameters in order: a
    pointer for each pointer, c_int for int, c_longlong for long long,
    c_float for float (a mismatch passes garbage, or cuts a pointer)."""
    import ctypes
    import re

    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_longlong: "long long",
             ctypes.c_float: "float"}
    sources = "".join(p.read_text() for p in sorted(_build.CSRC_DIR.glob("*.cu")))
    for name, argtypes in _build._SIGNATURES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', sources).group(1)
        got = ["ptr" if "*" in p else " ".join(p.split()[:-1]) for p in params.split(",")]
        assert got == [kinds[a] for a in argtypes], name
