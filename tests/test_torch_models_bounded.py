"""The 11 registry families with bounded, varying-start or quad nests:
the port's ``engine.run(device="cpu")`` vs ``pluss.engine.run`` at n=16
with four threads, exactly, and their CRI and MRC to rtol 1e-12 (the
rectangular families: tests/test_torch_models.py)."""

import numpy as np
import pytest

from pluss import cri as jax_cri
from pluss import mrc as jax_mrc
from pluss.config import SamplerConfig as JaxConfig
from pluss_torch import cri, mrc
from pluss_torch.config import SamplerConfig
from tests.test_torch_models import BOUNDED, assert_run_matches_jax


@pytest.mark.parametrize("model", BOUNDED)
def test_run_matches_jax(model):
    assert_run_matches_jax(model)


@pytest.mark.parametrize("model", ["cholesky", "trmm", "syrk_tri", "durbin"])
def test_cri_and_mrc_match_jax(model):
    got, want = assert_run_matches_jax(model)
    cfg = SamplerConfig()
    ri_t = cri.distribute(got.noshare_list(), got.share_list(),
                          cfg.thread_num)
    ri_j = jax_cri.distribute(want.noshare_list(), want.share_list(),
                              cfg.thread_num)
    assert sorted(ri_t) == sorted(ri_j)
    np.testing.assert_allclose([ri_t[k] for k in sorted(ri_t)],
                               [ri_j[k] for k in sorted(ri_j)], rtol=1e-12)
    np.testing.assert_allclose(mrc.aet_mrc(ri_t, cfg),
                               jax_mrc.aet_mrc(ri_j, JaxConfig()), rtol=1e-12)
