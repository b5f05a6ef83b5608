"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for
the tests: the same files, the same code paths, the port's plain
versions in place of its kernels."""

import time

import torch

from perf_bench.harness import cell, spec

SEED = 2 ** 31 + 12345
PLAN = "band:p=0.85:lo=1:hi=17;band:p=0.10:lo=17:hi=65;band:p=0.05:lo=65:hi=200"
#: the limit of ``recall_miss`` at this size, by entry (recall depends
#: on the size): sound runs read at most 0.0135 (IVF-Flat) and 0.1017
#: (IVF-PQ) over 12 seeds on the CPU; the planted training faults of
#: ``test_training_faults_fail`` at least 0.074 and 0.138 over 3
RECALL_MISS = {"ivf_flat": 0.035, "ivf_pq": 0.12}


def shrink(c: spec.Cell) -> spec.Cell:
    c.config["data"].update(n_rows=4000, n_queries=300, components=128)
    c.config["index"].update(n_lists=16, kmeans_n_iters=5)
    c.config["search"]["n_probes"] = 4
    c.config["serve"]["max_batch"] = 128
    c.config["check"]["limits"]["recall_miss"] = RECALL_MISS[
        c.config["entry"]]
    if c.traffic["kind"] == "batch":
        c.traffic["queries_per_call"] = 300
    else:
        c.traffic.update(rate_qps=1000, plan=PLAN)
    return c


def cell_of(workload: str, root=spec.ROOT) -> spec.Cell:
    return shrink(spec.load(workload, root))


def run(c: spec.Cell, seconds: float = 0.5, trace: bool = False,
        entry=None, control: bool = False, seed: int = SEED):
    return cell.run(c, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), entry=entry, control=control)
