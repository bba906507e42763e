"""The kernels' build key: a library's name carries a hash of its source,
the local headers it includes and the flags, so an edited header rebuilds
every source that includes it. Nothing here runs ``nvcc``."""

import pytest

from phantom_vlb_tpu_torch.ops import _build


def _write(path, text):
    path.write_text(text)
    return path


def test_library_name_follows_an_included_header(tmp_path):
    header = _write(tmp_path / "core.cuh", "#pragma once\nconstexpr int kTile = 128;\n")
    _write(tmp_path / "deep.cuh", "constexpr int kDeep = 1;\n")
    source = _write(tmp_path / "kernel.cu", '#include <cuda.h>\n#include "core.cuh"\n  # include "deep.cuh"\n')
    first = _build._library(source)
    assert _build._library(source) == first                    # nothing changed: same name
    assert first.parent == _build.BUILD_DIR and first.name.startswith("kernel-")
    header.write_text("#pragma once\nconstexpr int kTile = 64;\n")
    second = _build._library(source)
    assert second != first                                     # only the header changed
    _write(tmp_path / "deep.cuh", "constexpr int kDeep = 2;\n")
    assert _build._library(source) not in (first, second)      # a second local include
    assert _build._library(source, ("PROBE",)) != _build._library(source)   # the macros count


def test_header_includes_are_followed_transitively_and_once(tmp_path):
    _write(tmp_path / "a.cuh", '#include "b.cuh"\n')
    b = _write(tmp_path / "b.cuh", '#include "a.cuh"\nint x;\n')   # a cycle
    source = _write(tmp_path / "k.cu", '#include "a.cuh"\n#include "missing.cuh"\n')
    assert [p.name for p in _build._sources(source)] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build._library(source)
    b.write_text('#include "a.cuh"\nint y;\n')
    assert _build._library(source) != before                  # reached only through a.cuh


def test_the_attention_sources_hash_their_core():
    for name in ("flash_fwd.cu", "ring_fwd.cu"):
        names = [p.name for p in _build._sources(_build.CSRC_DIR / name)]
        assert names == [name, "attn_fwd.cuh", "hopper.cuh"]
        assert "-lcuda" in _build._flags(_build.CSRC_DIR / name)


@pytest.mark.parametrize("name", ["flash_bwd.cu", "lora_epilogue.cu", "lora_dropout.cu"])
def test_the_tma_sources_hash_the_shared_primitives(name):
    # An edit of hopper.cuh rebuilds every kernel that includes it.
    assert [p.name for p in _build._sources(_build.CSRC_DIR / name)] == [name, "hopper.cuh"]
    assert "-lcuda" in _build._flags(_build.CSRC_DIR / name)
