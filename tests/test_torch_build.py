"""ops/build.py without a GPU: the compilers' log is kept beside the
library and read back when the library is already built, so the ptxas
register and stack figures stay readable on a warm build directory.

A stand-in for nvcc (a small Python script) plays the compiler: for ``-c``
it prints a ptxas-like line and writes the object, for the link it writes
the library. Nothing here loads the library.
"""
import stat
import sys

import pytest

from eldorado_tpu_torch.ops import build


def _no_nvcc():
    raise AssertionError("nvcc was called on an already built library")


@pytest.fixture
def fake_nvcc(tmp_path):
    path = tmp_path / "nvcc"
    path.write_text(
        f"#!{sys.executable}\n"
        "import pathlib, sys\n"
        "args = sys.argv[1:]\n"
        "out = pathlib.Path(args[args.index('-o') + 1])\n"
        "if '-c' in args:\n"
        "    print(f'ptxas info    : Used 7 registers, {args[-1]}')\n"
        "out.write_bytes(b'built')\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_warm_build_reads_the_log_back(tmp_path, monkeypatch):
    lib = tmp_path / build.library_name()
    lib.write_bytes(b"built")
    log = "ptxas info    : Used 96 registers\n    3552 bytes stack frame\n"
    lib.with_suffix(".log").write_text(log)
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    path, _, got = build.build(tmp_path)
    assert path == lib and got == log


def test_cold_build_writes_the_log(tmp_path, monkeypatch, fake_nvcc):
    out = tmp_path / "out"
    monkeypatch.setattr(build, "_nvcc", lambda: fake_nvcc)
    lib, _, log = build.build(out)
    assert lib.read_bytes() == b"built"
    for src in build.SOURCES:   # one compile per source, each logged
        assert f"== {src}\nptxas info    : Used 7 registers, " \
               f"{build.CSRC / src}\n" in log
    assert lib.with_suffix(".log").read_text() == log
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])   # no temporary left
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    assert build.build(out)[2] == log
