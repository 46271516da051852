"""Fixtures for the port's tests of the native feeder binding.

``native_lib`` builds a private copy of ``native/libpelfeeder.so`` with the
repo's Makefile (``make -C native LIB=<tmp>/libpelfeeder.so``), so that no
test reads a library another process is still writing, and skips where no
C++ toolchain exists.  Both packages cache the library they found in
``native._LIB`` for the process; ``force_native`` and ``force_numpy`` set
that cache in both, so that a parity test takes the same branch on both
sides whatever ran before it.
"""

import ctypes
import os
import subprocess

import pytest

import pim_embedding_lookup_tpu.utils.native as jnative
import pim_embedding_lookup_tpu_torch.utils.native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_native(out_dir) -> str | None:
    """Path of a fresh build of the library in ``out_dir``, or None where
    it cannot be built."""
    so = os.path.join(str(out_dir), "libpelfeeder.so")
    try:
        r = subprocess.run(["make", "-C", os.path.join(REPO, "native"), f"LIB={so}"],
                           capture_output=True, timeout=300)
    except FileNotFoundError:  # no make
        return None
    return so if r.returncode == 0 and os.path.exists(so) else None


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """A private build's path, or None without a toolchain."""
    return build_native(tmp_path_factory.mktemp("native"))


@pytest.fixture(scope="module")
def native_so(native_build):
    if native_build is None:
        pytest.skip("no C++ toolchain to build native/libpelfeeder.so")
    return native_build


@pytest.fixture(scope="module")
def native_lib(native_so):
    return tnative._declare(ctypes.CDLL(native_so))


@pytest.fixture
def force_native(monkeypatch, native_lib):
    monkeypatch.setattr(tnative, "_LIB", native_lib)
    monkeypatch.setattr(jnative, "_LIB", native_lib)
    return native_lib


@pytest.fixture
def force_numpy(monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", False)
    monkeypatch.setattr(jnative, "_LIB", False)
