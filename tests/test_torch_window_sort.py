"""The sort window's packed key sort (``pluss_torch/ops/window_sort.py``)
on the CPU.

- The plain version (the packed key, one ``torch.sort``, the unpacking)
  equals ``sort_columns`` on every valid entry of random ghost-merged
  windows (key, pos, span, valid; the valid prefix is as long), and gives
  every invalid entry the fixed fill: int32 and int64 positions (past
  2^31), ghosts never touched (-1) and carried from earlier positions, two
  arrays' line ranges with a gap between them, a slice of thread rows of
  a wider carried table;
- it asserts the layout's promise: a real position below the window's
  start, past its span, or a line outside the ranges raises;
- ``key_layout`` gives the widths the engine reckons, and None past 63
  bits or past CUB's item count;
- the engine sends every sort window of a small cholesky and a sampled
  GEMM through it, equal to ``pluss``, and ``engine.sort_window.packed``
  counts each; a window whose key is too wide takes ``sort_columns``,
  equal all the same, and ``.two_pass`` counts it;
- the wrapper refuses what neither version takes; the launcher, its
  library replaced by a recorder, packs each block into its columns,
  sorts over the key's bits, unpacks, counts one launch a window, calls
  the library inside the profiler range ``pluss::window_sort`` and raises
  on a failed launch.

The kernels themselves are held to the plain version on the card
(tests/test_torch_card.py).
"""

import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import sampling as jax_sampling
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine, obs, sampling
from pluss_torch.config import SamplerConfig
from pluss_torch.ops import build
from pluss_torch.ops import window_sort as ws_mod
from pluss_torch.ops.reuse import LINE_SENTINEL, ghost_entries, sort_columns
from pluss_torch.ops.window_sort import (KeyLayout, key_layout, window_sort,
                                         window_sort_plain)
from pluss_torch.spec_codec import spec_from_json

#: share spans of the random windows' codes (0 is the ghosts')
SPANS = (0, 7, 300)

#: (line_base, count) of the covered arrays: one, or two with a gap
RANGES = {"one": ((5, 40),), "gap": ((5, 40), (70, 25))}


def random_window(seed, pdt=torch.int32, ghosts="carried", ranges="one",
                  rows=None, n_parts=(37, 50, 13)):
    """``(parts, n, ranges, win_start, last_pos, pos_span)`` of a random
    ghost-merged window: each row's real entries at distinct positions in
    ``[win_start, win_start + pos_span)`` on the covered lines, a tenth of
    them invalid with any line and position; the carried table's covered
    lines -1 (``ghosts="cold"``) or, for two thirds, an earlier position.
    ``rows``: a slice of the thread rows of a wider table (and of the
    enumeration), as a sliced dispatch hands it over; the table then has a
    dump column past its lines, as the sharded window's has."""
    rng = np.random.default_rng(seed)
    rg = RANGES[ranges]
    lines = np.concatenate([np.arange(b, b + c) for b, c in rg])
    T, L = 6, 100
    rows = slice(None) if rows is None else rows
    R = len(range(T)[rows])
    n = sum(n_parts)
    pos_span = 3 * n
    base = 4 * n + (3 << 31 if pdt == torch.int64 else 0)
    win_start = base + rng.integers(0, 50, T)
    pos = np.stack([win_start[t] + rng.permutation(pos_span)[:n]
                    for t in range(T)])
    line = rng.choice(lines, (T, n)).astype(np.int32)
    code = rng.integers(0, len(SPANS), (T, n)).astype(np.uint8)
    valid = rng.random((T, n)) < 0.9
    # invalid entries hold anything: lines past the ranges, positions
    # below the window
    line = np.where(valid, line, rng.integers(0, 1 << 20, (T, n)))
    pos = np.where(valid, pos, rng.integers(-5, base, (T, n)))
    table = np.full((T, L + 1), -1, np.int64)
    if ghosts == "carried":
        table[:, lines] = np.where(rng.random((T, len(lines))) < 2 / 3,
                                   rng.integers(0, base, (T, len(lines))), -1)
    last_pos = torch.from_numpy(table).to(pdt)[rows, :L]
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a[rows])).to(dt)
    parts, off = [], 0
    for k in n_parts:
        sl = slice(off, off + k)
        parts.append((as_t(line[:, sl], torch.int32), as_t(pos[:, sl], pdt),
                      as_t(code[:, sl], torch.uint8),
                      as_t(valid[:, sl], torch.bool)))
        off += k
    assert last_pos.shape[0] == R
    return parts, n, rg, as_t(win_start, pdt), last_pos, pos_span


def columns(parts, ranges, last_pos):
    """The window as ``sort_columns`` takes it: the parts, then the
    ghosts, concatenated, each code as its span."""
    spans = torch.tensor(SPANS, dtype=torch.int32)
    blocks = [(line, pos, spans[code.long()], valid)
              for line, pos, code, valid in parts]
    blocks += [ghost_entries(last_pos[:, b:b + c], b) for b, c in ranges]
    return [torch.cat([blk[i] for blk in blocks], 1) for i in range(4)]


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("ghosts", ["cold", "carried"])
@pytest.mark.parametrize("ranges,rows", [("one", None), ("gap", None),
                                         ("gap", slice(1, 4)),
                                         ("one", slice(5, 6))])
def test_plain_version_equals_sort_columns(pdt, ghosts, ranges, rows):
    parts, n, rg, win_start, last_pos, pos_span = random_window(
        1, pdt, ghosts, ranges, rows)
    R = last_pos.shape[0]
    n_lines = sum(c for _, c in rg)
    lay = key_layout(rg, pos_span, len(SPANS), R, n + n_lines)
    assert lay is not None
    want = sort_columns(columns(parts, rg, last_pos))
    got = window_sort(iter(parts), n, rg, lay, win_start, last_pos,
                      torch.tensor(SPANS, dtype=torch.int32))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (R, n + n_lines)
    key_s, pos_s, span_s, valid_s = got
    nv = want[3].sum(1)
    assert torch.equal(valid_s.sum(1), nv)
    for r in range(R):
        k = int(nv[r])
        assert valid_s[r, :k].all() and not valid_s[r, k:].any()
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g[r, :k], w[r, :k])
        # the fill of the invalid entries
        assert (key_s[r, k:] == LINE_SENTINEL).all()
        assert (pos_s[r, k:] == -1).all() and (span_s[r, k:] == 0).all()
    # the windows hold what the comparison needs
    assert (~want[3]).any() and (want[2] > 0).any()
    if ghosts == "carried":
        ghost = (pos_s < win_start[:, None]) & valid_s
        assert ((pos_s >= 0) & ghost).any() and ((pos_s < 0) & ghost).any()


@pytest.mark.parametrize("fault", ["before", "past", "line", "code"])
def test_plain_version_holds_the_layouts_promise(fault):
    parts, n, rg, win_start, last_pos, pos_span = random_window(2)
    lay = key_layout(rg, pos_span, len(SPANS), last_pos.shape[0],
                     n + rg[0][1])
    line, pos, code, valid = parts[1]
    i = int(valid[0].nonzero()[0])
    if fault == "before":
        pos[0, i] = win_start[0] - 1
    elif fault == "past":
        pos[0, i] = win_start[0] + (1 << lay.pos_bits)
    elif fault == "line":
        line[0, i] = rg[0][0] + rg[0][1] + 40
    else:
        code[0, i] = len(SPANS)
    with pytest.raises(AssertionError, match="does not hold entry"):
        window_sort(iter(parts), n, rg, lay, win_start, last_pos,
                    torch.tensor(SPANS, dtype=torch.int32))


def test_key_layout_widths():
    # cholesky-2000's largest window: 500,000 lines, a 64,460,012-entry
    # span, 4 rows, spans {0, s}
    lay = key_layout(((0, 500_000),), 64_460_012, 2, 4, 64_960_012)
    assert lay == KeyLayout(line_lo=0, line_bits=19, pos_bits=26,
                            code_bits=1, row_bits=2)
    assert lay.width == 48
    assert (lay.s_rel, lay.s_line, lay.s_row) == (1, 27, 46)
    assert lay.line_ones == (1 << 19) - 1 >= 500_000
    # a range that starts past line 0, and one row
    lay = key_layout(((1000, 24), (2000, 8)), 1, 1, 1, 40)
    assert (lay.line_lo, lay.line_bits, lay.pos_bits, lay.code_bits,
            lay.row_bits) == (1000, 10, 1, 0, 0)
    # too wide a key, too many entries
    assert key_layout(((0, 1 << 30),), 1 << 33, 2, 4, 10) is None
    assert key_layout(((0, 8),), 8, 2, 4, 1 << 30) is None


def carried(js):
    return spec_from_json(jax_spec_to_json(js))


def sort_windows(pl) -> int:
    """Sort windows of a plan's run: every window off the template path
    that has refs to sort, and each template window whose arrays without
    a template or an overlay still sort."""
    n = 0
    for np_ in pl.nests:
        ultra = np_.ultra_windows()
        n += int((~ultra).sum()) * bool(np_.refs) \
            + int(ultra.sum()) * bool(np_.var_refs_novl)
    return n


def counted(tmp_path, fn):
    """``fn()`` with telemetry on; returns its result and the counters."""
    obs.configure(str(tmp_path / "t.jsonl"))
    try:
        out = fn()
        return out, obs.counters()
    finally:
        obs.shutdown()


@pytest.mark.parametrize("wide", [False, True])
def test_cholesky_windows_take_the_packed_sort(tmp_path, monkeypatch, wide):
    """Every sort window of a small cholesky run packs; with keys capped
    at 8 bits every one takes the two-pass sort instead.  Both equal
    ``pluss``."""
    if wide:
        monkeypatch.setattr(ws_mod, "MAX_KEY_BITS", 8)
    js = jax_models.REGISTRY["cholesky"](24)
    want = jax_engine.run(js, JaxConfig(chunk_size=1), window_accesses=1)
    spec, cfg = carried(js), SamplerConfig(chunk_size=1)
    got, cnt = counted(tmp_path, lambda: engine.run(
        spec, cfg, device="cpu", window_accesses=1))
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    pl = engine.plan(spec, cfg, window_accesses=1)
    n = sort_windows(pl)
    assert n >= 4 and pl.pos_dtype == np.int32
    on, off = ("two_pass", "packed") if wide else ("packed", "two_pass")
    assert cnt[f"engine.sort_window.{on}"] == n
    assert f"engine.sort_window.{off}" not in cnt


def test_sampled_gemm_windows_take_the_packed_sort(tmp_path):
    js = jax_models.REGISTRY["gemm"](32)
    rk = {"rate": 0.25, "window_accesses": 1 << 12, "seed": 5}
    want = jax_sampling.sampled_run(js, JaxConfig(), **rk)
    got, cnt = counted(tmp_path, lambda: sampling.sampled_run(
        carried(js), SamplerConfig(), device="cpu", **rk))
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert cnt["engine.sort_window.packed"] >= 2
    assert "engine.sort_window.two_pass" not in cnt


def test_int64_positions_pack(tmp_path, monkeypatch):
    """A plan past the int32 position range packs its windows too (the
    position threshold lowered, so a small run takes int64 positions)."""
    js = jax_models.REGISTRY["cholesky"](16)
    want = jax_engine.run(js)
    real = engine.plan

    def plan64(*a, **k):
        pl = real(*a, **k)
        return dataclasses.replace(pl, pos_dtype=np.dtype(np.int64))

    monkeypatch.setattr(engine, "plan", plan64)
    engine._plan_cached.cache_clear()
    try:
        got, cnt = counted(tmp_path, lambda: engine.run(carried(js),
                                                        device="cpu"))
    finally:
        engine._plan_cached.cache_clear()
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert cnt["engine.sort_window.packed"] >= 1


def _inputs():
    parts, n, rg, win_start, last_pos, pos_span = random_window(3)
    lay = key_layout(rg, pos_span, len(SPANS), last_pos.shape[0],
                     n + rg[0][1])
    return parts, n, rg, lay, win_start, last_pos, \
        torch.tensor(SPANS, dtype=torch.int32)


@pytest.mark.parametrize("bad", ["win_start_dtype", "win_start_shape",
                                 "spans_dtype", "spans_short_code",
                                 "last_pos_stride", "last_pos_lines",
                                 "part_dtype", "part_shape", "part_count",
                                 "too_wide"])
def test_wrapper_refuses_bad_inputs(bad):
    parts, n, rg, lay, win_start, last_pos, spans = _inputs()
    if bad == "win_start_dtype":
        win_start = win_start.to(torch.int64)
    elif bad == "win_start_shape":
        win_start = win_start[:-1]
    elif bad == "spans_dtype":
        spans = spans.to(torch.int64)
    elif bad == "spans_short_code":
        spans = torch.zeros(5, dtype=torch.int32)   # past 2 code bits
    elif bad == "last_pos_stride":
        last_pos = last_pos.t().contiguous().t()
    elif bad == "last_pos_lines":
        last_pos = last_pos[:, :30]
    elif bad == "part_dtype":
        parts[0] = (parts[0][0].to(torch.int64),) + parts[0][1:]
    elif bad == "part_shape":
        parts[0] = tuple(t[:, :-1] for t in parts[0])
    elif bad == "part_count":
        n += 1
    else:
        lay = KeyLayout(lay.line_lo, lay.line_bits, 64 - lay.line_bits,
                        lay.code_bits, lay.row_bits)
    with pytest.raises(ValueError):
        window_sort(iter(parts), n, rg, lay, win_start, last_pos, spans)


class _Recorder:
    """The kernel library's stand-in: records each entry point's call and
    returns ``err`` from the named one."""

    def __init__(self, fail=None, err=700):
        self.calls, self.fail, self.err = [], fail, err
        self.layouts = []

    def __getattr__(self, name):
        if not name.startswith("pluss_window_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            if name.startswith("pluss_window_pack_i"):
                lay = ws_mod._Layout.from_address(args[7])
                self.layouts.append({f: getattr(lay, f)
                                     for f, _ in lay._fields_})
            torch.ones(1)                    # an operator at the call
            return self.err if name == self.fail else 0

        return fn


@pytest.fixture
def recorded(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(ws_mod, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=77))
    return lib


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
def test_launcher_packs_sorts_unpacks(recorded, tmp_path, pdt):
    parts, n, rg, win_start, last_pos, pos_span = random_window(
        4, pdt, ranges="gap", rows=slice(1, 4))
    R, N = last_pos.shape[0], n + 65
    lay = key_layout(rg, pos_span, len(SPANS), R, N)
    spans = torch.tensor(SPANS, dtype=torch.int32)
    before = window_sort.launches
    out, cnt = counted(tmp_path, lambda: ws_mod._launch(
        iter(parts), n, rg, lay, win_start, last_pos, spans))
    assert window_sort.launches == before + 1
    assert cnt["kernel.launches.window_sort"] == 1
    assert [(t.dtype, t.shape) for t in out] == [
        (torch.int32, (R, N)), (pdt, (R, N)), (torch.int32, (R, N)),
        (torch.bool, (R, N))]
    sfx = "i64" if pdt == torch.int64 else "i32"
    names = [c[0] for c in recorded.calls]
    assert names == [f"pluss_window_pack_{sfx}"] * 3 \
        + ["pluss_window_pack_ghosts"] * 2 \
        + ["pluss_window_sort_bytes", "pluss_window_sort",
           f"pluss_window_unpack_{sfx}"]
    offs = [c[1][10] for c in recorded.calls[:3]]
    assert offs == [0, 37, 87]
    assert [c[1][:3] for c in recorded.calls[3:5]] == [
        (R, 40, 0), (R, 25, 65)]
    assert [c[1][6] for c in recorded.calls[3:5]] == [n, n + 40]
    assert recorded.calls[5][1][:2] == (R * N, lay.width)
    sort = recorded.calls[6][1]
    assert sort[2:4] == (R * N, lay.width) and sort[6] == 77
    unpack = recorded.calls[7][1]
    assert unpack[1:3] == (R, N)
    assert unpack[4:6] == (last_pos.data_ptr(), last_pos.stride(0))
    assert unpack[5] == 101                  # the dump column's stride
    assert unpack[8:12] == tuple(t.data_ptr() for t in out)
    assert recorded.layouts == [{
        "line_lo": lay.line_lo, "line_ones": lay.line_ones,
        "rel_mask": (1 << lay.pos_bits) - 1,
        "code_mask": (1 << lay.code_bits) - 1, "s_rel": lay.s_rel,
        "s_line": lay.s_line, "s_row": lay.s_row}] * 3


def test_launches_sit_in_their_profiler_range(recorded):
    parts, n, rg, lay, win_start, last_pos, spans = _inputs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("engine.sort_window"):
            ws_mod._launch(iter(parts), n, rg, lay, win_start, last_pos,
                           spans)
    ev = prof.events()
    ranges = [e for e in ev if e.name == "pluss::window_sort"]
    # a pack a part and a range, the sort, the unpack; the size query
    # launches nothing and sits outside
    assert len(ranges) == 3 + 1 + 1 + 1
    assert all(r.cpu_parent.name == "engine.sort_window" for r in ranges)
    ones = [e for e in ev if e.name == "aten::ones"]
    assert len(ones) == 7
    assert sum(o.cpu_parent.name == "pluss::window_sort" for o in ones) == 6


@pytest.mark.parametrize("fail", ["pluss_window_pack_i32",
                                  "pluss_window_pack_ghosts",
                                  "pluss_window_sort_bytes",
                                  "pluss_window_sort",
                                  "pluss_window_unpack_i32"])
def test_launcher_raises_on_a_failed_call(monkeypatch, recorded, fail):
    recorded.fail = fail
    parts, n, rg, lay, win_start, last_pos, spans = _inputs()
    before = window_sort.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ws_mod._launch(iter(parts), n, rg, lay, win_start, last_pos, spans)
    assert window_sort.launches == before


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    parts, n, rg, lay, win_start, last_pos, spans = _inputs()
    monkeypatch.setattr(ws_mod, "_launch", None)   # never reached
    want = window_sort_plain(iter(parts), n, rg, lay, win_start, last_pos,
                             spans)
    got = window_sort(iter(parts), n, rg, lay, win_start, last_pos, spans)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("device,want", [("cuda", True), ("cpu", False)])
def test_build_kernels_loads_the_window_sort(monkeypatch, device, want):
    loaded = []
    monkeypatch.setattr(build, "load", loaded.append)
    pl = engine.plan(carried(jax_models.REGISTRY["cholesky"](16)),
                     SamplerConfig())
    engine._build_kernels(pl, torch.device(device))
    assert ("window_sort" in loaded) == want


@pytest.mark.parametrize("model", ["gemm", "syrk"])
def test_template_and_overlay_nests_upload_no_span_table(monkeypatch, model):
    """A nest that no window sorts (gemm's templates, syrk's overlay) never
    builds the span table or the clock's position spans: they are made by
    the first sort window."""
    def never(self):
        raise AssertionError("a nest without a sort window built it")

    monkeypatch.setattr(engine.DeviceNest, "span_table", property(never))
    monkeypatch.setattr(engine.DeviceNest, "_pos_spans", property(never))
    js = jax_models.REGISTRY[model](64)
    want = jax_engine.run(js)
    got = engine.run(carried(js), SamplerConfig(), device="cpu")
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw


def test_device_nest_builds_its_sort_tables_on_first_use():
    pl = engine.plan(carried(jax_models.REGISTRY["cholesky"](24)),
                     SamplerConfig())
    dn = engine.DeviceNest(pl, 0, torch.device("cpu"))
    assert not {"span_table", "_pos_spans"} & set(vars(dn))
    assert dn.span_table.tolist() == dn.spans
    assert dn.span_table.dtype == torch.int32
    np_ = pl.nests[0]
    clock = np_.clock.reshape(SamplerConfig().thread_num, np_.n_windows, -1)
    for w in range(np_.n_windows):
        span = int((clock[:, w, -1] - clock[:, w, 0]).max()) + np_.body
        assert dn.pos_span(w) == span
    assert dn.span_table is dn.span_table


KERNEL_SOURCES = sorted(
    p for p in (Path(engine.__file__).parent / "csrc").glob("*.cu"))


@pytest.mark.parametrize("src", KERNEL_SOURCES, ids=lambda p: p.stem)
def test_every_kernel_is_profiled_counted_and_prebuilt(monkeypatch, src):
    """Each CUDA source's kernels carry a symbol prefix the profile's
    port-kernel table matches, its wrapper is among the soak's counted
    wrappers, and the soak builds it before it spawns a process."""
    from pluss_torch import profile, soak

    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src.read_text())
    assert names
    for name in names:
        assert any(p in name for p in profile.PORT_KERNELS), name
    built = []
    monkeypatch.setattr(build, "build", lambda *n: built.extend(n))
    soak.prebuild(torch.device("cuda"))
    assert src.stem in built
    wrappers = soak._wrappers()
    assert len(wrappers) == len(KERNEL_SOURCES)
    assert all(isinstance(w.launches, int) for w in wrappers.values())
