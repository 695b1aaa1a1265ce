"""The kernel build's cache key (``ops/cuda/_build.py``), without ``nvcc``:
a library is named by a hash of its source, of every header beside it and
of the flags, so an edited header rebuilds every source."""

import os
import shutil

from paddle_tpu_torch.ops.cuda import _build


def _copy_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst,
                    ignore=shutil.ignore_patterns("build"))
    return dst


def test_every_source_has_a_stable_library_path(tmp_path):
    src = _copy_csrc(tmp_path)
    for name in sorted(os.listdir(src)):
        if name.endswith(".cu"):
            a = _build._lib_path(str(src / name))
            b = _build._lib_path(str(src / name))
            assert a == b
            assert os.path.basename(a).startswith(name[:-3] + "-")
            assert os.path.dirname(a) == _build.BUILD_DIR


def test_a_header_edit_changes_the_library_path(tmp_path):
    src = _copy_csrc(tmp_path)
    headers = [n for n in os.listdir(src) if n.endswith(".cuh")]
    assert headers, "csrc holds the shared tensor-core header"
    source = str(src / "moe_ffn.cu")
    before = _build._lib_path(source)
    with open(src / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = _build._lib_path(source)
    assert after != before
    # a new header counts as well
    (src / "extra.cuh").write_text("#pragma once\n")
    assert _build._lib_path(source) not in (before, after)


def test_a_source_edit_changes_only_its_own_library(tmp_path):
    src = _copy_csrc(tmp_path)
    moe, paged = str(src / "moe_ffn.cu"), str(src / "paged_attention.cu")
    before = (_build._lib_path(moe), _build._lib_path(paged))
    with open(moe, "a") as f:
        f.write("\n// edited\n")
    assert _build._lib_path(moe) != before[0]
    assert _build._lib_path(paged) == before[1]
