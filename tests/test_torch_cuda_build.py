"""The port's kernel build key (`ops/cuda_build.source_digest`): a library
is reused only while its source, every local header it includes (followed
recursively) and the compiler flags are unchanged.  Runs on the CPU: it
hashes files and compiles nothing."""

import os

import pytest

from unimoe_audio_torch.ops import cuda_build
from tests.torch_threads import one_torch_thread  # noqa: F401


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture
def tree(tmp_path):
    root = str(tmp_path)
    _write(os.path.join(root, "k.cu"), '#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    _write(os.path.join(root, "a.cuh"), '#pragma once\n  #  include "sub/b.cuh"\nint a;\n')
    _write(os.path.join(root, "sub", "b.cuh"), "int b;\n")
    return root


@pytest.mark.parametrize("edit", ["k.cu", "a.cuh", "sub/b.cuh"])
def test_digest_follows_local_headers(tree, edit):
    """An edit to the source or to any header it reaches changes the key."""
    src = os.path.join(tree, "k.cu")
    before = cuda_build.source_digest(src)
    assert cuda_build.source_digest(src) == before
    with open(os.path.join(tree, edit), "a") as f:
        f.write("// edited\n")
    assert cuda_build.source_digest(src) != before


def test_digest_follows_flags_not_system_headers(tree):
    """Other flags give another key; a system include is not read."""
    src = os.path.join(tree, "k.cu")
    assert cuda_build.source_digest(src, cuda_build.NVCC_FLAGS + ("-lineinfo",)) \
        != cuda_build.source_digest(src)
    assert len(cuda_build.source_digest(src)) == 16


def test_shipped_sources_hash_their_headers(tmp_path):
    """The wgmma sources (all three: K1, K2 and K3, the grouped GEMMs)
    include the shared Hopper headers (PTX wrappers, the TMA encoder and the
    per-device kernel set-up), and their keys cover them: an edit to either
    header changes the key of every source (checked on a copy of csrc/)."""
    import shutil

    names = ("flash_attention_fwd", "flash_attention_bwd", "grouped_gemm")
    for name in names:
        with open(os.path.join(cuda_build.CSRC_DIR, name + ".cu"), "rb") as f:
            text = f.read()
        assert b'#include "hopper_ptx.cuh"' in text and b'#include "hopper_tma.cuh"' in text
        assert b"<mma.h>" not in text and b"static bool" not in text
        assert len(cuda_build.source_digest(os.path.join(cuda_build.CSRC_DIR,
                                                         name + ".cu"))) == 16
    copy = str(tmp_path / "csrc")
    shutil.copytree(cuda_build.CSRC_DIR, copy)
    srcs = [os.path.join(copy, n + ".cu") for n in names]
    for header in ("hopper_ptx.cuh", "hopper_tma.cuh"):
        before = [cuda_build.source_digest(s) for s in srcs]
        with open(os.path.join(copy, header), "a") as f:
            f.write("// edited\n")
        after = [cuda_build.source_digest(s) for s in srcs]
        assert all(a != b for a, b in zip(after, before)), header
