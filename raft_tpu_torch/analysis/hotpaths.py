"""The declared hot-path registry (port of ``raft_tpu/analysis/hotpaths.py``
:59-112, with the port's own files and function names).

These are the paths whose contract is "per-row data never round-trips
the host": the serving engine's dispatch path, every neighbors search
program, the build populate path, the multi-rank merges and the k-means
EM loop.  An entry is module-wide or scoped to named functions (a module
like ``kmeans.py`` touches the host in its training prologue — only the
EM loop bodies are hot).  Consumed by
:mod:`raft_tpu_torch.analysis.rules.host_transfer` and
:mod:`~raft_tpu_torch.analysis.rules.trace_purity`; sanctioned host reads
inside a hot path carry ``# exempt(hot-path-host-transfer): why`` (legacy
``host-ok`` still parses), and together they are the list later speed work
starts from (PERF.md §3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HotPath:
    """One declared hot path.

    ``pattern`` matches as a posix-path substring (directories end with
    ``/``) or suffix (module files); ``functions`` — when non-empty —
    limits the rules to the bodies of the named functions (methods
    included).  Every declared name is pinned against its module's AST by
    a tier-1 test, so a rename fails loudly instead of voiding the entry.
    ``staging=True`` (the tiered residency layer): the host→device copy
    of a cold tile is a designed transfer, so the staging calls
    (``.to(..., non_blocking=True)``, ``copy_(..., non_blocking=True)``)
    are surfaces too and must carry the
    ``tier-staging(hot-path-host-transfer): why`` marker at the one
    sanctioned call site."""

    pattern: str
    functions: Tuple[str, ...] = ()
    why: str = ""
    staging: bool = False

    def matches(self, posix: str) -> bool:
        return self.pattern in posix


#: The registry.  Order is documentation order; the rules union matches.
HOT_PATHS: Tuple[HotPath, ...] = (
    HotPath("raft_tpu_torch/neighbors/ann_mnmg.py",
            functions=("_ivf_flat_program", "_ivf_pq_program",
                       "_brute_force_program", "_allgather_packed",
                       "_merge_one_allgather", "dispatch", "warm_local",
                       "_ivf_flat_scan", "_ivf_pq_scan", "_brute_force_scan",
                       "_fold_parts", "_gather_fold"),
            why="a sharded search is one program per batch on every rank "
                "with one allgather; a host read serializes every rank "
                "behind one host thread"),
    HotPath("raft_tpu_torch/neighbors/_build.py",
            why="the build's populate path keeps per-row data on the "
                "device; only (n_lists,)-shaped counts may be read, "
                "marked"),
    HotPath("raft_tpu_torch/neighbors/knn_mnmg.py",
            why="the multi-part kNN merge is one allgather and a device "
                "fold; a host read brings back the gather-to-host merge"),
    HotPath("raft_tpu_torch/neighbors/_common.py",
            why="the chunked-list pack and scan layer: only (n_lists,)-"
                "shaped table bookkeeping may be read, marked"),
    HotPath("raft_tpu_torch/serve/",
            why="the serving loop runs device work on two lanes; an "
                "unmarked read would serialize them (host request "
                "assembly and result delivery are sanctioned, marked).  "
                "Covers the scheduler, admission, the autotuner and the "
                "control plane too: they run per dispatch"),
    HotPath("raft_tpu_torch/neighbors/brute_force.py",
            functions=("_knn_scan_impl", "_knn_batched"),
            why="the tiled kNN scan program"),
    HotPath("raft_tpu_torch/neighbors/ivf_flat.py",
            functions=("_search_batch_impl", "_probe_search_impl"),
            why="the one-batch IVF-Flat search and its probe scan (the "
                "tiered phases dispatch the latter)"),
    HotPath("raft_tpu_torch/neighbors/tiering.py",
            functions=("dispatch", "_dispatch", "_hot_phase", "_scan",
                       "_stage", "_use", "_run_cold", "_refine",
                       "_refine_impl", "_hot_phase_impl", "_scan_block"),
            staging=True,
            why="the tiered two-phase dispatch: per-row data crosses the "
                "host/device boundary only at the one staging call site "
                "(cold-tile prefetch, refine-vector copy) and the refine's "
                "one id read"),
    HotPath("raft_tpu_torch/neighbors/ivf_pq.py",
            functions=("_search_batch_impl", "_full_search_impl",
                       "coarse_probes", "_scan_steps", "_scan_per_step",
                       "_scan_legacy", "_encode_tile"),
            why="the IVF-PQ search and encode programs"),
    HotPath("raft_tpu_torch/cluster/kmeans.py",
            functions=("fused_em_step", "fused_em_step_batched", "_em_body",
                       "_fit_main", "min_cluster_and_distance"),
            why="the fused EM loop reads x once an iteration; a host read "
                "inside it serializes every iteration (the loop's one "
                "convergence read an iteration is marked)"),
    HotPath("raft_tpu_torch/cluster/kmeans_mnmg.py",
            functions=("_step", "_inertia", "compute_new_centroids"),
            why="the MNMG EM step is one allreduce an iteration; a host "
                "read inside it serializes every rank"),
)


def match(posix: str) -> Optional[Tuple[HotPath, ...]]:
    """Every registry entry covering *posix*, or None."""
    hits = tuple(hp for hp in HOT_PATHS if hp.matches(posix))
    return hits or None
