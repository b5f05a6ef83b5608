"""The autotuner on the card: from ``warm_candidates()`` through
exploration, a params promotion and its rollback no kernel library is
built or loaded (``native.BUILDS``) and no warmed signature is added;
live results under the promoted config are bit for bit its solo search;
a candidate that would serve the plain ``"torch"`` versions on the card
is refused; cost rows round-trip through ``core.coststore`` under the
card's scope.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_autotune.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.core import coststore
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.kernels import native
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.serve import (AutoTuner, Candidate, ServeEngine,
                                  TunerConfig)
from raft_tpu_torch.serve.autotune import BASELINE

pytestmark = pytest.mark.cuda

_DIM, _K = 32, 10
SIZES = (1, 7, 64, 3, 200, 33, 128, 2, 90, 5)


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(0)
    c = rng.uniform(-3, 3, (64, _DIM))

    def draw(n):
        return (c[rng.integers(0, 64, n)]
                + rng.standard_normal((n, _DIM))).astype(np.float32)

    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=64, pq_dim=16),
                         draw(20_000), device="cuda")
    return index, [draw(n) for n in SIZES]


def _engine(index, reqs):
    eng = ServeEngine(index, _K, ivf_pq.SearchParams(n_probes=8),
                      max_batch=256, device="cuda")
    eng.warmup()
    eng.search(reqs)
    return eng


def test_tune_builds_and_warms_nothing(setup):
    index, reqs = setup
    eng = _engine(index, reqs)
    try:
        sp1 = ivf_pq.SearchParams(n_probes=16)
        tuner = AutoTuner(eng, TunerConfig(seed=0, pairs=1,
                                           shadow_requests=8),
                          param_variants=[sp1])
        assert tuner.warm_candidates() == len(eng.warmed_buckets())
        frozen = (dict(native.BUILDS), eng.warmed_signatures())
        tuner.explore()
        tuner.promote(Candidate("params0", params=sp1))
        outs = eng.search(reqs)
        for q, (d, i) in zip(reqs, outs):
            sd, si = ivf_pq.search(sp1, index, q, _K)
            np.testing.assert_array_equal(d, sd.cpu().numpy())
            np.testing.assert_array_equal(i, si.cpu().numpy())
        assert tuner.maybe_rollback(live_p99_s=100 * tuner._pre_p99)
        assert eng._ctor["params"].n_probes == 8 and eng.max_batch == 256
        assert (dict(native.BUILDS), eng.warmed_signatures()) == frozen
    finally:
        eng.close()


def test_shadow_replay_scores_finished_work(setup):
    index, reqs = setup
    eng = _engine(index, reqs)
    try:
        tuner = AutoTuner(eng, TunerConfig(seed=0))
        score = tuner._measure_real(BASELINE, reqs)
        assert score.served == 1.0 and score.recall == 1.0
        assert 0 < score.qps < 1e8 and score.p99_s > 0
        # cap64 skips the requests above its ladder (200, 128 and 90 rows)
        capped = tuner._measure_real(Candidate("cap64", max_batch=64), reqs)
        assert capped.served == pytest.approx(0.7)
    finally:
        eng.close()


def test_plain_engine_candidate_is_refused(setup):
    index, reqs = setup
    eng = _engine(index, reqs)
    try:
        tuner = AutoTuner(eng, extra_candidates=[Candidate(
            "plain", params=ivf_pq.SearchParams(n_probes=8),
            engine="torch")])
        with pytest.raises(LogicError, match="plain"):
            tuner.warm_candidates()
    finally:
        eng.close()


def test_cost_rows_round_trip_under_the_card_scope(setup, tmp_path):
    index, reqs = setup
    prev = coststore.install(str(tmp_path))
    try:
        eng = _engine(index, reqs)
        fn, rows = eng._backend_fn(), eng._cost.rows()
        assert rows
        eng.close()
        assert "sm_" in coststore.device_scope("cuda")
        assert coststore.installed().load_costs(fn, "cuda") == \
            pytest.approx(rows)
        assert coststore.installed().load_costs(fn, "cpu") == {}
        eng2 = ServeEngine(index, _K, ivf_pq.SearchParams(n_probes=8),
                           max_batch=256, device="cuda")
        assert eng2._cost.rows() == pytest.approx(rows)
        eng2.close()
    finally:
        coststore.install(prev)
