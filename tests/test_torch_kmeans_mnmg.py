"""Multi-GPU k-means: the port at W = 4 (a gloo world of 4 processes)
against the JAX package's ``kmeans_mnmg`` on a mesh of 4 CPU devices and
against the port's own single-device ``fit``, from the same centroids, on
seeded blobs of 1,600 × 12 with k = 4 (``tests/test_kmeans_mnmg.py``'s
shape): all three loops, ``compute_new_centroids`` fused and unfused with
weights, ``predict``, the allreduce counts and bytes, uneven rows
refused."""

import pathlib

import numpy as np
import pytest
import torch

W = 4
N, D, K = 1600, 12, 4
MAX_ITER = 50
LOOPS = ("device", "fori", "host")


def _data():
    rng = np.random.default_rng(11)
    centers = rng.uniform(-6, 6, (K, D)).astype(np.float32)
    labels = rng.integers(0, K, N)
    x = (centers[labels] + 0.4 * rng.standard_normal((N, D))).astype(
        np.float32)
    c0 = (centers + 0.5 * rng.standard_normal((K, D))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    return x, c0, w


def _battery(comms, payload):
    from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans_mnmg
    from raft_tpu_torch.core.error import LogicError

    x, c0, w = (torch.from_numpy(a) for a in _data())
    params = KMeansParams(n_clusters=K, init=InitMethod.Array,
                          max_iter=MAX_ITER)
    out = {}
    calls = comms.collective_calls
    for loop in LOOPS:
        before = (calls["allreduce"], calls["allreduce_bytes"])
        fit = kmeans_mnmg.fit(params, comms, x, centroids=c0, loop=loop)
        out[loop] = {"centroids": fit.centroids.numpy(),
                     "inertia": float(fit.inertia),
                     "n_iter": int(fit.n_iter),
                     "calls": (calls["allreduce"] - before[0],
                               calls["allreduce_bytes"] - before[1])}
    per = N // comms.get_size()
    rows = slice(comms.get_rank() * per, (comms.get_rank() + 1) * per)
    for fused in (True, False):
        before = calls["allreduce"]
        new, wsum, inertia = kmeans_mnmg.compute_new_centroids(
            x[rows], c0, comms, sample_weights=w[rows], fused=fused)
        out[f"step_fused={fused}"] = (new.numpy(), wsum.numpy(),
                                      float(inertia),
                                      calls["allreduce"] - before)
    labels, inertia = kmeans_mnmg.predict(params, comms, x,
                                          out["device"]["centroids"])
    out["predict"] = (labels.numpy(), float(inertia))
    try:
        kmeans_mnmg.fit(params, comms, x[:N - 1], centroids=c0)
        out["uneven"] = "ran"
    except LogicError as e:
        out["uneven"] = "divisible" in str(e)
    pp = kmeans_mnmg.fit(KMeansParams(n_clusters=K, max_iter=5, seed=3),
                         comms, x)
    out["kmeans||"] = pp.centroids.numpy()
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_kmeans_mnmg:_battery", W,
                     workdir=tmp_path_factory.mktemp("kmeans_mnmg"),
                     timeout=180,
                     sys_path=[str(pathlib.Path(__file__).parent)])


@pytest.fixture(scope="module")
def jax_comms():
    import jax
    from jax.sharding import Mesh

    from raft_tpu.comms import build_comms

    return build_comms(Mesh(np.array(jax.devices()[:W]), ("world",)))


@pytest.fixture(scope="module")
def jax_fits(jax_comms):
    from raft_tpu.cluster import InitMethod, KMeansParams, kmeans_mnmg

    x, c0, _ = _data()
    params = KMeansParams(n_clusters=K, init=InitMethod.Array,
                          max_iter=MAX_ITER)
    return {loop: kmeans_mnmg.fit(params, jax_comms, x, centroids=c0,
                                  loop=loop) for loop in LOOPS}


def test_ranks_agree(port):
    for out in port[1:]:
        for loop in LOOPS:
            np.testing.assert_array_equal(out[loop]["centroids"],
                                          port[0][loop]["centroids"])
            assert out[loop]["n_iter"] == port[0][loop]["n_iter"]
        np.testing.assert_array_equal(out["kmeans||"], port[0]["kmeans||"])


@pytest.mark.parametrize("loop", LOOPS)
def test_fit_matches_jax(port, jax_fits, loop):
    got, want = port[0][loop], jax_fits[loop]
    np.testing.assert_allclose(got["centroids"], np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-6)
    assert got["n_iter"] == int(want.n_iter)
    assert got["inertia"] == pytest.approx(float(want.inertia), rel=1e-5)


@pytest.mark.parametrize("loop", LOOPS)
def test_fit_matches_single_device(port, loop):
    from raft_tpu_torch import cluster
    from raft_tpu_torch.cluster import InitMethod, KMeansParams

    x, c0, _ = _data()
    single = cluster.fit(KMeansParams(n_clusters=K, init=InitMethod.Array,
                                      max_iter=MAX_ITER), x, centroids=c0,
                         device="cpu")
    got = port[0][loop]
    np.testing.assert_allclose(got["centroids"], single.centroids.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert got["inertia"] == pytest.approx(float(single.inertia), rel=1e-5)
    if loop != "host":   # host reads δ² every 8 steps only
        assert got["n_iter"] == int(single.n_iter)


@pytest.mark.parametrize("loop", LOOPS)
def test_allreduce_count_and_bytes(port, loop):
    """One allreduce of the packed (k·d + k + 1) partials a step it runs,
    and one of the final inertia (4 bytes)."""
    got = port[0][loop]
    steps = MAX_ITER if loop == "fori" else got["n_iter"]
    if loop == "host":
        assert steps % 8 == 0 or steps == MAX_ITER
    assert got["calls"] == (steps + 1, steps * (K * D + K + 1) * 4 + 4)


@pytest.mark.parametrize("fused", [True, False])
def test_compute_new_centroids_with_weights(port, jax_comms, fused):
    from jax.sharding import PartitionSpec as P

    from raft_tpu.cluster import kmeans_mnmg

    x, c0, w = _data()

    def body(xs, ws, c):
        return kmeans_mnmg.compute_new_centroids(xs, c, jax_comms,
                                                 sample_weights=ws,
                                                 fused=fused)

    spec = P(jax_comms.axis_name)
    new, wsum, inertia = jax_comms.run(body, x, w, c0,
                                       in_specs=(spec, spec, P()),
                                       out_specs=(P(), P(), P()))
    for out in port:
        got_new, got_w, got_inertia, n_calls = out[f"step_fused={fused}"]
        np.testing.assert_allclose(got_new, np.asarray(new), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got_w, np.asarray(wsum), rtol=1e-5)
        assert got_inertia == pytest.approx(float(inertia), rel=1e-5)
        assert n_calls == (1 if fused else 3)


def test_predict_labels(port, jax_comms):
    from raft_tpu.cluster import KMeansParams, kmeans_mnmg

    x, _, _ = _data()
    c = port[0]["device"]["centroids"]
    labels, inertia = kmeans_mnmg.predict(KMeansParams(n_clusters=K),
                                          jax_comms, x, c)
    labels = np.asarray(labels)
    d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    srt = np.sort(d, axis=1)
    near_tie = srt[:, 1] - srt[:, 0] <= 1e-5 * srt[:, 1]
    for out in port:
        got, got_inertia = out["predict"]
        assert got.shape == (N,) and got.dtype == np.int32
        assert not ((got != labels) & ~near_tie).any()
        assert got_inertia == pytest.approx(float(inertia), rel=1e-5)


def test_uneven_rows_refused(port):
    assert all(out["uneven"] is True for out in port)


def test_fused_and_unfused_steps_agree(port):
    """Both step forms give every rank the same global per-cluster
    weights; the k-means‖ init (every rank draws the same) is finite."""
    for out in port:
        np.testing.assert_allclose(out["step_fused=True"][1],
                                   out["step_fused=False"][1], rtol=1e-5)
        assert torch.isfinite(torch.from_numpy(out["kmeans||"])).all()
