"""The distributed layer on the card: a world of one over NCCL (every
self-test; MNMG k-means and kNN bit for bit their single-device
counterparts, with kernels B1, B2, B3 and B5 launched) and a world of two
gloo processes on the one card (every collective on CUDA tensors equal to
its value from the inputs, the operations gloo does not take CUDA
tensors for counted as staged through the host, MNMG k-means and kNN
against the single-device results).

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
run them with
``python -m pytest --noconftest tests/test_torch_cuda_mnmg.py -q -m cuda``.
"""

import pathlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N, D, K_CLUSTERS = 20_000, 32, 64
N_INDEX, NQ, K = 50_000, 600, 10


def _blobs(device):
    from raft_tpu_torch.random import RngState, make_blobs

    x, _, _ = make_blobs(RngState(3), N, D, n_clusters=K_CLUSTERS,
                         cluster_std=1.0, device=device)
    return x, x[::N // K_CLUSTERS][:K_CLUSTERS].clone()


def _index(device):
    gen = torch.Generator(device=device).manual_seed(5)
    return (torch.randn(N_INDEX, D, generator=gen, device=device),
            torch.randn(NQ, D, generator=gen, device=device))


def _battery(comms, payload):
    """Every rank: MNMG k-means and kNN with their launches, the self-tests
    and (gloo) each collective on CUDA tensors."""
    from raft_tpu_torch.cluster import InitMethod, KMeansParams, kmeans_mnmg
    from raft_tpu_torch.comms import ReduceOp, self_tests
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.kernels import native
    from raft_tpu_torch.neighbors.knn_mnmg import knn_mnmg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = comms.device
    out = {"self_tests": self_tests.run_all(comms)}
    x, c0 = _blobs(dev)
    params = KMeansParams(n_clusters=K_CLUSTERS, init=InitMethod.Array)
    native.reset_launches()
    fit = kmeans_mnmg.fit(params, comms, x, centroids=c0)
    labels, _ = kmeans_mnmg.predict(params, comms, x, fit.centroids)
    out["kmeans"] = (fit.centroids.cpu().numpy(), int(fit.n_iter),
                     labels.cpu().numpy(), dict(native.LAUNCHES))
    xi, q = _index(dev)
    native.reset_launches()
    out["knn"] = {}
    for name, metric in (("l2", DistanceType.L2SqrtExpanded),
                         ("l1", DistanceType.L1)):
        for part in ("index", "queries"):
            d, i = knn_mnmg(comms, xi, q, K, metric, partition=part,
                            device=dev)
            out["knn"][name, part] = (d.cpu().numpy(), i.cpu().numpy())
    out["knn_launches"] = dict(native.LAUNCHES)
    r, w = comms.get_rank(), comms.get_size()
    v = torch.arange(6, dtype=torch.float32, device=dev) + r + 1
    out["ops"] = {
        "allreduce": comms.allreduce(v).cpu().numpy(),
        "allreduce_max": comms.allreduce(v, ReduceOp.MAX).cpu().numpy(),
        "bcast": comms.bcast(v, root=w - 1).cpu().numpy(),
        "allgather": comms.allgather(v).cpu().numpy(),
        "reducescatter": comms.reducescatter(v.repeat(w)).cpu().numpy(),
        "sendrecv": comms.device_sendrecv(
            v, [(j, (j + 1) % w) for j in range(w)]).cpu().numpy(),
    }
    out["calls"] = dict(comms.collective_calls)
    return out


def _run(tmp_path, world, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from raft_tpu_torch.testing.world import run_world

    return run_world("test_torch_cuda_mnmg:_battery", world,
                     workdir=tmp_path, backend=backend, device="cuda",
                     timeout=300,
                     sys_path=[str(pathlib.Path(__file__).parent)])


@pytest.fixture(scope="module")
def single():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from raft_tpu_torch import cluster
    from raft_tpu_torch.cluster import InitMethod, KMeansParams
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.neighbors import brute_force

    torch.backends.cuda.matmul.allow_tf32 = False
    x, c0 = _blobs("cuda")
    params = KMeansParams(n_clusters=K_CLUSTERS, init=InitMethod.Array)
    fit = cluster.fit(params, x, centroids=c0)
    labels, _ = cluster.predict(params, x, fit.centroids)
    xi, q = _index("cuda")
    knn = {}
    for name, metric in (("l2", DistanceType.L2SqrtExpanded),
                         ("l1", DistanceType.L1)):
        d, i = brute_force.knn(xi, q, K, metric, device="cuda")
        tie_d, _ = brute_force.knn(xi, q, K + 1, metric, device="cuda")
        knn[name] = (d.cpu().numpy(), i.cpu().numpy(), tie_d.cpu().numpy())
    return {"kmeans": (fit.centroids.cpu().numpy(), int(fit.n_iter),
                       labels.cpu().numpy()), "knn": knn}


@pytest.fixture(scope="module")
def nccl1(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("nccl1"), 1, "nccl")[0]


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("gloo2"), 2, "gloo")


def test_nccl_world_of_one_self_tests(nccl1):
    assert all(nccl1["self_tests"].values()), nccl1["self_tests"]


def test_nccl_world_of_one_kmeans_is_single_device(nccl1, single):
    c, n_iter, labels, launches = nccl1["kmeans"]
    np.testing.assert_array_equal(c, single["kmeans"][0])
    assert n_iter == single["kmeans"][1]
    np.testing.assert_array_equal(labels, single["kmeans"][2])
    assert launches["fused_l2_nn"] > 0 and launches["fused_l2_nn_partials"] > 0


def test_nccl_world_of_one_knn_is_single_device(nccl1, single):
    for (name, part), (d, i) in nccl1["knn"].items():
        rd, ri, _ = single["knn"][name]
        np.testing.assert_array_equal(d, rd, err_msg=f"{name} {part}")
        np.testing.assert_array_equal(i, ri, err_msg=f"{name} {part}")
    assert nccl1["knn_launches"]["select_k"] > 0
    assert nccl1["knn_launches"]["pairwise_accumulate"] > 0
    assert not any(k.endswith("_host_staged") for k in nccl1["calls"])


def test_gloo_two_ranks_collectives_on_cuda_tensors(gloo2):
    from raft_tpu_torch.comms.comms import GLOO_CUDA_OPS

    v = [np.arange(6, dtype=np.float32) + r + 1 for r in range(2)]
    for r, out in enumerate(gloo2):
        assert all(out["self_tests"].values()), out["self_tests"]
        ops = out["ops"]
        np.testing.assert_array_equal(ops["allreduce"], v[0] + v[1])
        np.testing.assert_array_equal(ops["allreduce_max"], v[1])
        np.testing.assert_array_equal(ops["bcast"], v[1])
        np.testing.assert_array_equal(ops["allgather"], np.stack(v))
        # each rank's input is its v twice: chunk r of the sum
        np.testing.assert_array_equal(ops["reducescatter"], v[0] + v[1])
        np.testing.assert_array_equal(ops["sendrecv"], v[1 - r])
        for name in ("allreduce", "bcast", "allgather", "reducescatter",
                     "device_sendrecv"):
            staged = out["calls"].get(f"{name}_host_staged", 0)
            assert (staged == 0) == (name in GLOO_CUDA_OPS), (name, staged)


def test_gloo_two_ranks_kmeans_and_knn(gloo2, single):
    for out in gloo2:
        c, _, labels, launches = out["kmeans"]
        np.testing.assert_allclose(c, single["kmeans"][0], rtol=1e-5,
                                   atol=1e-5)
        assert (labels == single["kmeans"][2]).mean() >= 0.999
        assert launches["fused_l2_nn_partials"] > 0
        for (name, part), (d, i) in out["knn"].items():
            rd, ri, tie_d = single["knn"][name]
            if name == "l1":   # B5 sums every pair in one fixed order
                np.testing.assert_array_equal(d, rd)
                np.testing.assert_array_equal(i, ri)
                continue
            np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-6)
            gap = (np.abs(np.diff(tie_d, axis=1))
                   <= 1e-5 * np.abs(tie_d[:, 1:]))
            tied = np.zeros((NQ, K), bool)
            tied |= gap[:, :K]
            tied[:, 1:] |= gap[:, :K - 1]
            assert not ((i != ri) & ~tied).any(), (name, part)
        assert out["knn_launches"]["pairwise_accumulate"] > 0
