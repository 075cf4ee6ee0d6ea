"""The build key of the port's CUDA sources (``ops/_build.py``).

A library is rebuilt when its key changes; the key must cover the shared
headers (``csrc/*.cuh``) as well as the source, or an edited header would
leave a stale library in a persistent build directory.  Run on a temporary
copy of ``csrc/``; no compiler is needed."""

import shutil
from pathlib import Path

import pytest

from tpu_dist_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(CSRC, dst)
    return dst


@pytest.mark.parametrize("name", _build.SOURCES)
def test_digest_moves_with_the_shared_header(csrc_copy, name):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "the sources share at least one header"
    before = _build.source_digest(name, csrc_copy)
    assert _build.source_digest(name, csrc_copy) == before  # stable
    header = headers[0]
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.source_digest(name, csrc_copy) != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_digest_moves_with_the_source_and_a_new_header(csrc_copy, name):
    before = _build.source_digest(name, csrc_copy)
    (csrc_copy / "extra.cuh").write_text("// a new shared header\n")
    with_header = _build.source_digest(name, csrc_copy)
    assert with_header != before
    src = csrc_copy / f"{name}.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _build.source_digest(name, csrc_copy) != with_header


def test_digest_of_the_checkout_names_the_built_library():
    """The key the loader builds under is the checkout's own."""
    for name in _build.SOURCES:
        assert _build.source_digest(name) == _build.source_digest(name, CSRC)
