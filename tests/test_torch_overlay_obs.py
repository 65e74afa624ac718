"""The interleave overlay window's telemetry: the ``engine.overlay_window``
tally and the ``engine.overlay_windows`` counter.

syrk's ``A`` (``A[i][k]`` beside ``A[j][k]``) takes the overlay in every
clean window; gemm has no overlaid array.  With telemetry on, a syrk
dispatch records one ``engine.overlay_window`` tally whose calls are the
plan's ultra windows times its overlaid arrays, as the counter counts
them; the results are bit for bit those with telemetry off.
"""

import numpy as np
import pytest

from pluss_torch import engine, obs
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.obs import stats as stats_mod

CFG = SamplerConfig(thread_num=4, chunk_size=4)

#: overlay windows of syrk at T4 c4 per (n, window_accesses): one clean
#: window at the default size, the plan's finer split below it
SYRK_WINDOWS = {(64, None): 1, (64, 1 << 12): 4, (64, 1 << 14): 4,
                (128, None): 1, (128, 1 << 12): 8, (128, 1 << 14): 8}


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.shutdown()
    engine._plan_cached.cache_clear()
    yield
    obs.shutdown()


def _overlay_windows(pl) -> int:
    """Ultra windows times overlaid arrays, summed over the plan's nests."""
    return sum(len(np_.overlays) * sum(
        len(w_list) for ultra, w_list, _ in engine._segments_of(np_)
        if ultra) for np_ in pl.nests)


def _traced_run(tmp_path, model, n, wa):
    path = str(tmp_path / f"{model}{n}-{wa}.jsonl")
    obs.configure(path)
    res = engine.run(REGISTRY[model](n), CFG, device="cpu",
                     window_accesses=wa)
    counters = obs.counters()
    obs.shutdown()
    recs, problems, _ = stats_mod.load(path)
    assert problems == [], problems
    return res, counters, [r for r in recs if r.get("ev") == "span"]


@pytest.mark.parametrize("n,wa", sorted(SYRK_WINDOWS, key=str))
def test_syrk_counts_each_overlay_window(tmp_path, n, wa):
    pl = engine.plan(REGISTRY["syrk"](n), CFG, window_accesses=wa)
    assert engine.plan_path(pl) == "template+overlay"
    assert _overlay_windows(pl) == SYRK_WINDOWS[n, wa]
    res, counters, spans = _traced_run(tmp_path, "syrk", n, wa)
    assert counters["engine.overlay_windows"] == SYRK_WINDOWS[n, wa]
    (disp,) = [r for r in spans if r["name"] == "engine.dispatch"]
    (tally,) = [r for r in spans if r["name"] == "engine.overlay_window"]
    assert tally["parent"] == disp["id"]
    assert tally["attrs"]["calls"] == SYRK_WINDOWS[n, wa]
    assert 0 <= tally["dur"] <= disp["dur"] + 1e-6
    assert res.max_iteration_count == pl.total_count


@pytest.mark.parametrize("n,wa", [(64, None), (64, 1 << 12),
                                  (128, None), (128, 1 << 14)])
def test_gemm_records_no_overlay_window(tmp_path, n, wa):
    pl = engine.plan(REGISTRY["gemm"](n), CFG, window_accesses=wa)
    assert "overlay" not in engine.plan_path(pl)
    _, counters, spans = _traced_run(tmp_path, "gemm", n, wa)
    assert "engine.overlay_windows" not in counters
    assert "engine.overlay_window" not in {r["name"] for r in spans}
    assert "engine.template_window" in {r["name"] for r in spans}


@pytest.mark.parametrize("n,wa", [(64, None), (64, 1 << 12),
                                  (128, 1 << 14)])
def test_syrk_results_equal_with_telemetry_on_and_off(tmp_path, n, wa):
    off = engine.run(REGISTRY["syrk"](n), CFG, device="cpu",
                     window_accesses=wa)
    on, counters, _ = _traced_run(tmp_path, "syrk", n, wa)
    assert counters["engine.overlay_windows"] > 0
    np.testing.assert_array_equal(off.noshare_dense, on.noshare_dense)
    assert off.share_raw == on.share_raw
    assert off.max_iteration_count == on.max_iteration_count
