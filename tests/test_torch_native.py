"""The port's native line mapper vs the numpy compactor and the JAX
package's mapper, exactly; the build of the host libraries.

``pluss_torch.trace._Compactor.map_raw`` (over ``csrc/map_lines.cpp``,
built at first use into ``pluss_torch/_build/``) must assign the ids
``_Compactor.map`` assigns to ``lines_of(raw)`` while the table holds one
cluster, including addresses with bit 63 set (the arithmetic shift of the
signed value) and precompacted line ids (shift 0); a chunk that leaves the
cluster, and any table of two clusters, return None.  Where the JAX
package's native library builds, its ``map_raw`` gives the same ids.  A
failed build of either host library (the mapper, the plan's window
template) raises.  Addresses come from numpy seeds.
"""

import os

import numpy as np
import pytest

from pluss import native as jax_native
from pluss import trace as jt
from pluss_torch import engine, native, trace as tt
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.ops import build

SHIFT = 6


def one_cluster(lines) -> tt._Compactor:
    """A compactor whose table holds exactly the cluster of ``lines``."""
    comp = tt._Compactor()
    comp.map(np.asarray(lines, np.int64))
    assert len(comp.starts) == 1
    return comp


def jax_compactor(comp: tt._Compactor) -> jt._Compactor:
    return jt._Compactor.restore(comp.snapshot())


def check_same_ids(comp, raw, shift):
    """``map_raw`` == ``map`` of the shifted lines (on a copy, so neither
    call sees the other's growth) and == JAX's ``map_raw`` when JAX's
    native library is there."""
    want = tt._Compactor.restore(comp.snapshot()).map(
        raw.astype(np.int64) >> shift)
    got = comp.map_raw(raw, shift)
    assert got is not None and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if jax_native.line_mapper() is not None:
        np.testing.assert_array_equal(
            jax_compactor(comp).map_raw(raw, shift), got)
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_single_cluster_matches_map(seed):
    rng = np.random.default_rng(seed)
    base = int(rng.integers(1 << 20, 1 << 36))
    lines = base + rng.integers(0, 5000, 20_000)
    comp = one_cluster(lines)
    # the slack past the observed end is inside the cluster too
    raw = ((base + rng.integers(0, 5000 + comp.slack, 30_000))
           .astype(np.uint64) << np.uint64(SHIFT)) \
        | rng.integers(0, 64, 30_000).astype(np.uint64)
    got = check_same_ids(comp, raw, SHIFT)
    assert got.min() >= 0 and got.max() < comp.next_free


def test_bit_63_set_maps_as_lines_of():
    """Addresses with bit 63 set shift as signed int64 (``lines_of``): the
    cluster sits at negative line numbers and the ids match."""
    rng = np.random.default_rng(2)
    raw = (np.uint64(1 << 63) | (rng.integers(0, 3000, 8000)
                                 .astype(np.uint64) << np.uint64(SHIFT)))
    lines = tt.lines_of(raw.astype(np.int64))
    np.testing.assert_array_equal(lines, jt.lines_of(raw.astype(np.int64)))
    assert lines.max() < 0
    comp = one_cluster(lines)
    got = check_same_ids(comp, raw, SHIFT)
    np.testing.assert_array_equal(got, lines - comp.starts[0])


def test_precompacted_shift_zero():
    rng = np.random.default_rng(3)
    lines = (1 << 40) + rng.integers(0, 4000, 6000)
    comp = one_cluster(lines)
    check_same_ids(comp, lines.astype(np.uint64), 0)


def test_chunk_leaving_the_cluster_returns_none():
    """One line past the cluster (or before it) and the mapper declines;
    the feed then maps with ``map``, which discovers the new cluster."""
    rng = np.random.default_rng(4)
    lines = 1000 + rng.integers(0, 2000, 5000)
    comp = one_cluster(lines)
    end = int(comp.starts[0] + comp.widths[0])
    for stray in (end, int(comp.starts[0]) - 1, 1 << 45):
        chunk = np.append(lines, stray)
        raw = chunk.astype(np.uint64) << np.uint64(SHIFT)
        assert comp.map_raw(raw, SHIFT) is None
        if jax_native.line_mapper() is not None:
            assert jax_compactor(comp).map_raw(raw, SHIFT) is None
    # the compact stage falls back to map and grows the table
    stage = tt._compact_stage(comp, SHIFT, False, snapshot=False)
    raw = np.append(lines, 1 << 45).astype(np.uint64) << np.uint64(SHIFT)
    ids, n_lines, _ = stage(0, raw)
    assert len(comp.starts) == 2 and n_lines == comp.next_free
    assert ids[-1] == end - int(comp.starts[0])   # the new cluster's base


def test_two_clusters_not_taken():
    comp = tt._Compactor()
    comp.map(np.array([10, 20, 1 << 30], np.int64))
    assert len(comp.starts) == 2
    raw = np.array([10, 20], np.uint64) << np.uint64(SHIFT)
    assert comp.map_raw(raw, SHIFT) is None
    assert tt._Compactor().map_raw(raw, SHIFT) is None   # empty table


def test_compact_stage_matches_jax_over_a_stream():
    """The feed's compact stage, batch by batch, over a stream that grows
    one cluster, then adds a far one, then returns to the first: ids,
    table sizes and snapshots equal JAX's."""
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 3000, 4096),
               rng.integers(0, 9000, 4096),
               np.concatenate([rng.integers(0, 3000, 2048),
                               (1 << 31) + rng.integers(0, 100, 2048)]),
               rng.integers(0, 3000, 4096)]
    mine, theirs = tt._Compactor(), jt._Compactor()
    stage = tt._compact_stage(mine, SHIFT, False, snapshot=True)
    jstage = jt._compact_stage(theirs, SHIFT, False, snapshot=True)
    for b, lines in enumerate(batches):
        raw = lines.astype(np.uint64) << np.uint64(SHIFT)
        got, want = stage(b, raw), jstage(b, raw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


#: each host library of ``csrc/``, its loader (built at its first call)
#: and a use of it that has to build it
HOST_LIBS = {
    "map_lines": (native.line_mapper,
                  lambda: one_cluster(np.arange(100)).map_raw(
                      np.arange(100, dtype=np.uint64), 0)),
    "window_template": (native.template_builder,
                        lambda: engine.plan(REGISTRY["gemm"](16),
                                            SamplerConfig())),
}


@pytest.mark.parametrize("name", sorted(HOST_LIBS))
def test_mapper_library_is_built_by_hash_into_the_build_dir(
        tmp_path, monkeypatch, name):
    """Each host library lands in the build directory under a name that
    carries the hash of its source: an edited source is another file."""
    path = build.library_path(name)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith(f"lib{name}-")
    HOST_LIBS[name][0]()
    assert os.path.exists(path)
    src = os.path.join(build.CSRC, f"{name}.cpp")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    with open(src) as f:
        (csrc / f"{name}.cpp").write_text(f.read() + "// edited\n")
    monkeypatch.setattr(build, "CSRC", str(csrc))
    edited = build.library_path(name)
    assert edited != path
    assert os.path.basename(edited).startswith(f"lib{name}-")


def test_mapper_validates_its_arguments():
    m = native.line_mapper()
    with pytest.raises(ValueError, match="1-D"):
        m(np.zeros((2, 2), np.uint64), 6, 0, 10, 0)
    with pytest.raises(ValueError, match="shift"):
        m(np.zeros(4, np.uint64), 64, 0, 10, 0)


@pytest.mark.parametrize("name", sorted(HOST_LIBS))
@pytest.mark.parametrize("fault", ["no compiler", "compile error"])
def test_failed_build_raises(tmp_path, monkeypatch, fault, name):
    """Nothing falls back to numpy: a missing compiler and a source that
    does not compile both raise from the library's first use."""
    loader, use = HOST_LIBS[name]
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "no compiler":
        monkeypatch.setattr(build, "cxx", lambda: str(tmp_path / "no-c++"))
    else:
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / f"{name}.cpp").write_text("this is not C++\n")
        monkeypatch.setattr(build, "CSRC", str(csrc))
    loader.cache_clear()
    build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native build failed"):
            loader()
        with pytest.raises(RuntimeError, match="native build failed"):
            use()
    finally:
        loader.cache_clear()
        build.load.cache_clear()
