"""``kernels/build.py`` names each library by a hash of what it is built
from: its source, every header in ``csrc/`` and the flags, so an edited
header is rebuilt and never loaded stale. No ``nvcc`` is needed here."""

import shutil

import pytest

from feddrift_torch.kernels import build
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", str(copy))
    return copy


def test_sources_share_a_header():
    assert {"dense_rows.cu", "flash_attn_fwd.cu"} <= set(build._sources())
    for src in ("dense_rows.cu", "flash_attn_fwd.cu"):
        with open(f"{build.CSRC}/{src}") as f:
            assert '#include "mma_tf32.cuh"' in f.read()


@pytest.mark.parametrize("edited", ["mma_tf32.cuh", "dense_rows.cu"])
def test_an_edit_changes_the_library_name(csrc, edited):
    before = {src: build.lib_path(src) for src in build._sources()}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {src: build.lib_path(src) for src in build._sources()}
    for src in before:
        # a header edit renames every library, a source edit its own only
        changed = edited.endswith(".cuh") or src == edited
        assert (after[src] != before[src]) == changed, src


def test_a_new_header_changes_the_library_name(csrc):
    before = build.lib_path("local_sgd.cu")
    (csrc / "extra.cuh").write_text("// a header\n")
    assert build.lib_path("local_sgd.cu") != before
