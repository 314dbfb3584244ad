"""``ops/cuda_build.py`` names a built library by the hash of its source,
of every ``csrc/*.cuh`` header and of the flags, so that an edited shared
header rebuilds both kernels. Runs without ``nvcc``."""
import shutil

import pytest

from segmentation3d_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, dst)
    monkeypatch.setattr(cuda_build, "CSRC", str(dst))
    return dst


@pytest.mark.parametrize("name", ["thin_conv3d", "window_conv_i8"])
def test_editing_the_shared_header_renames_the_library(csrc_copy, name):
    before = cuda_build.library_path(name)
    header = csrc_copy / "conv_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = cuda_build.library_path(name)
    assert after != before
    assert after == cuda_build.library_path(name)  # stable for the same tree


def test_a_new_header_renames_the_library(csrc_copy):
    before = cuda_build.library_path("thin_conv3d")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path("thin_conv3d") != before


def test_another_kernel_source_leaves_the_library_name(csrc_copy):
    before = cuda_build.library_path("thin_conv3d")
    src = csrc_copy / "window_conv_i8.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.library_path("thin_conv3d") == before
    assert cuda_build.sources() == ["thin_conv3d", "window_conv_i8"]
