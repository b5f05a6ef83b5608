"""The IVF-PQ search calls' share, in %, of their roofline: the least
time of the traced calls (``counts/ivf_pq_search.py``: the larger of
operations at the float32-accurate tensor-core rate and bytes at the
HBM rate) over the device's busy time in the traced stretch, which holds
those calls and nothing else."""

import torch

from perf_bench.counts import ivf_pq_search


def read(ctx):
    tr = ctx.trace
    exp = ctx.export
    if (tr is None or tr.busy_s <= 0 or ctx.q_rows is None or exp is None
            or exp.get("kind") != "ivf_pq"):
        return None
    calls = len(tr.spans_named("bench.call"))
    if calls == 0:
        return None
    cfg = ctx.cell.config
    q = ctx.pool[torch.as_tensor(ctx.q_rows, device=ctx.pool.device)]
    labels = exp["labels"]
    sizes = torch.bincount(labels[labels >= 0],
                           minlength=exp["centers"].shape[0])
    cb = exp["codebooks"]
    w = ivf_pq_search.work(q, exp["centers"], sizes, exp["rotation"].shape[1],
                           cb.shape[0], int(exp["pq_bits"]),
                           int(cfg["search"]["n_probes"]), int(cfg["k"]))
    ctx.store[__name__] = w
    return 100.0 * calls * w["least_s"] / tr.busy_s
