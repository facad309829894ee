"""The kernel build's cache key (mapping_private_tpu_torch/_build.py).

A kernel's library is named after a hash of its source, of every header in
``csrc/`` and of the compiler flags, so an edit of a shared header can not
load a stale library.  Checked on a temporary copy of ``csrc/``: nothing
is compiled, no nvcc is needed."""
import ctypes
import re
import shutil

import pytest

from mapping_private_tpu_torch import _build


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    return dst


def _paths(csrc):
    return {name: _build._library_path(name, csrc) for name in _build.KERNELS}


def test_copy_hashes_like_the_package(csrc_copy):
    assert _paths(csrc_copy) == _paths(_build.CSRC_DIR)
    for name, path in _paths(csrc_copy).items():
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"{name}-")


@pytest.mark.parametrize("header", sorted(p.name for p in _build.CSRC_DIR.glob("*.cuh")))
def test_library_path_follows_a_header_edit(csrc_copy, header):
    before = _paths(csrc_copy)
    with open(csrc_copy / header, "ab") as f:
        f.write(b"\n// edited\n")
    after = _paths(csrc_copy)
    assert all(after[name] != before[name] for name in _build.KERNELS)


def test_library_path_follows_a_new_header(csrc_copy):
    before = _paths(csrc_copy)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    after = _paths(csrc_copy)
    assert all(after[name] != before[name] for name in _build.KERNELS)


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_library_path_follows_its_own_source_only(csrc_copy, name):
    before = _paths(csrc_copy)
    with open(csrc_copy / f"{name}.cu", "ab") as f:
        f.write(b"\n// edited\n")
    after = _paths(csrc_copy)
    assert {n for n in _build.KERNELS if after[n] != before[n]} == {name}


def test_library_path_follows_the_flags(csrc_copy, monkeypatch):
    before = _paths(csrc_copy)
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    after = _paths(csrc_copy)
    assert all(after[name] != before[name] for name in _build.KERNELS)


def test_every_source_that_includes_the_header_is_a_kernel():
    """The sources on the shared skeleton include it and its shared pairs by
    their bare names, which nvcc resolves through ``-I csrc``: all three
    kernels."""
    for header in ("nn_search.cuh", "nn_pairs.cuh"):
        users = [p.stem for p in _build.CSRC_DIR.glob("*.cu") if f'#include "{header}"' in p.read_text()]
        assert sorted(users) == ["nn_argmin", "nn_gather", "nn_matmul"] == sorted(_build.KERNELS)


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_argument_types_follow_the_entry_point(name):
    """``KERNELS[name]`` lists, in order, the parameters of the source's
    ``extern "C" int <name>_launch(...)``: ``int`` or a pointer."""
    text = _build.source_path(name).read_text()
    params = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', text).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.split()[0] == "int" for p in params)
    assert _build.KERNELS[name] == want


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        _build.source_path("nn_nothing")
