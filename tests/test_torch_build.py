"""The kernel build's bookkeeping, which runs without nvcc: every csrc
source has its entry points registered, and a library is rebuilt when its
source or a shared header is newer than it (the compile itself needs the
CUDA toolkit, so here a rebuild shows as nvcc being looked for)."""

import os

import pytest

from tpudsp_torch.cuda import build


def test_every_source_is_registered():
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sources == sorted(build.SIGNATURES)
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == [
        "fm_discriminator.cuh", "scan_step.cuh", "tile_chain.cuh"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ with one source and one header, and a built library newer
    than both."""
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    (csrc / "k.cu").write_text("// source\n")
    (csrc / "h.cuh").write_text("// header\n")
    (out / "libk.so").write_bytes(b"")
    for i, p in enumerate((csrc / "k.cu", csrc / "h.cuh", out / "libk.so")):
        os.utime(p, (1000 + i, 1000 + i))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD", out)
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc looked for")))
    return csrc, out


def test_current_library_is_kept(tree):
    assert build.compile_source("k") == tree[1] / "libk.so"


@pytest.mark.parametrize("newer", ["k.cu", "h.cuh"])
def test_newer_source_or_header_rebuilds(tree, newer):
    os.utime(tree[0] / newer, (2000, 2000))
    with pytest.raises(RuntimeError, match="nvcc looked for"):
        build.compile_source("k")
