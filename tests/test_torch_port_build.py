"""The build of the port's CUDA kernels, on the CPU: a library's name
follows its source, every shared header and the flags, so an edit to any of
them loads a fresh build.  Nothing is compiled here."""

import pytest

from pim_embedding_lookup_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (src / "b.cu").write_text("__global__ void k() {}\n")
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", [
    lambda src: (src / "common.cuh").write_text("#pragma once\n// changed\n"),
    lambda src: (src / "other.cuh").write_text("#pragma once\n"),
    lambda src: (src / "a.cu").write_text("__global__ void k2() {}\n"),
], ids=["header changed", "header added", "source changed"])
def test_library_path_follows_source_and_headers(csrc, edit):
    before = _build._library_path("a")
    assert _build._library_path("a") == before  # the same files: the same library
    edit(csrc)
    assert _build._library_path("a") != before


def test_library_path_follows_flags(csrc, monkeypatch):
    before = _build._library_path("b")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._library_path("b") != before


def test_library_name_and_place(csrc):
    path = _build._library_path("b")
    assert path.parent == _build.BUILD and path.name.startswith("libb-")
    assert path.suffix == ".so"
