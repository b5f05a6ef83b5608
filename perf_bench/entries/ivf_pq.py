"""IVF-PQ: ``raft_tpu_torch.neighbors.ivf_pq`` — ``build``, ``search``
(a closed-loop call) and a ``ServeEngine`` over the index (open loop)."""

from __future__ import annotations

import types

from perf_bench.entries import common


def _params(cfg: dict):
    from raft_tpu_torch.neighbors import ivf_pq

    ip = dict(cfg["index"])
    ip["metric"] = common.metric(cfg["metric"])
    ip["codebook_kind"] = ivf_pq.CodebookKind[ip["codebook_kind"]]
    return ivf_pq.IndexParams(**ip), ivf_pq.SearchParams(**cfg["search"])


def prepare(cfg: dict, x, device) -> None:
    """Load the kernels and run one untimed build of the whole dataset,
    so the timed builds find every library loaded, every handle made and
    the allocator grown to the build's blocks."""
    from raft_tpu_torch.neighbors import ivf_pq

    common.load_kernels(device)
    ip, _ = _params(cfg)
    ivf_pq.build(ip, x, device=device)
    common.sync(device)


def build(cfg: dict, x, device):
    from raft_tpu_torch.neighbors import ivf_pq

    ip, sp = _params(cfg)
    index = ivf_pq.build(ip, x, device=device)
    return types.SimpleNamespace(index=index, search=sp, k=int(cfg["k"]),
                                 n=x.shape[0])


def call(system, q):
    from raft_tpu_torch.neighbors import ivf_pq

    return ivf_pq.search(system.search, system.index, q, system.k)


def dispatches_per_call(system, nq: int) -> int:
    return common.dispatches(nq)


def serve(system, max_batch: int):
    return common.Server(system.index, system.k, system.search, max_batch)


def export(system) -> dict:
    idx = system.index
    owner = idx.owner.long().clone()
    owner[-1] = -1
    labels, codes, dup = common.by_id(idx.list_indices, idx.phys_sizes,
                                      owner, idx.list_codes, system.n)
    return {"kind": "ivf_pq", "centers": idx.centers,
            "rotation": idx.rotation, "codebooks": idx.codebooks,
            "pq_bits": idx.pq_bits, "labels": labels, "codes": codes,
            "duplicates": dup}
