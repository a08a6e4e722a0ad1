"""The kernel library's build key (``kernels.source_hash``), on the CPU
without nvcc: it covers every source and every header in ``csrc/``, so an
edit to a header that the sources include names another library and is
rebuilt, while the sources compiled stay the ``*.cu`` files alone."""

import os
import re
import shutil

import pytest

from mvp_benchmark_tpu_torch.ops import kernels


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, dst)
    return str(dst)


def _names(paths):
    return [os.path.basename(p) for p in paths]


def test_the_hash_is_the_same_for_the_same_files(csrc):
    assert kernels.source_hash(csrc) == kernels.source_hash(kernels._CSRC)
    assert kernels.source_hash(csrc) == kernels.source_hash(csrc)


@pytest.mark.parametrize("name", ["hopper.cuh", "attention.cu"])
def test_editing_a_source_or_a_header_changes_the_hash(csrc, name):
    before, compiled = kernels.source_hash(csrc), _names(kernels._sources(csrc))
    with open(os.path.join(csrc, name), "a") as f:
        f.write("\n// edited\n")
    assert kernels.source_hash(csrc) != before
    assert _names(kernels._sources(csrc)) == compiled


@pytest.mark.parametrize("name", ["extra.cuh", "extra.h"])
def test_adding_a_header_changes_the_hash_not_the_sources_compiled(csrc, name):
    before, compiled = kernels.source_hash(csrc), _names(kernels._sources(csrc))
    with open(os.path.join(csrc, name), "w") as f:
        f.write("#pragma once\n")
    assert kernels.source_hash(csrc) != before
    assert _names(kernels._sources(csrc)) == compiled
    assert all(n.endswith(".cu") for n in compiled)


def test_the_flags_are_part_of_the_hash(csrc, monkeypatch):
    before = kernels.source_hash(csrc)
    monkeypatch.setattr(kernels, "NVCC_FLAGS", (*kernels.NVCC_FLAGS, "-DEXTRA"))
    assert kernels.source_hash(csrc) != before


def test_every_local_include_is_a_hashed_header():
    hashed = {n for n in os.listdir(kernels._CSRC) if n.endswith((".cu", ".cuh", ".h"))}
    for src in kernels._sources():
        with open(src) as f:
            for inc in re.findall(r'#include\s+"([^"]+)"', f.read()):
                assert inc in hashed, (os.path.basename(src), inc)
