"""Seeded data shaped like ann-benchmarks' SIFT-1M.

A frozen copy of the mixture ``chip_smoke.py`` draws (``mixture`` and the
centres of ``run``): rows around ``components`` N(0, 1) centres with
Gaussian noise of ``sigma``, made on the device in a few large calls.
The dataset and the query pool come from the same mixture, so queries
have near neighbours as SIFT's do.  The centres are the configuration's
(drawn from its ``centres_seed``) and the rows the run's (drawn from its
seed): every seed then indexes a corpus of the same structure, whose
lists, and so whose work, differ only by the draw of its rows.
"""

from __future__ import annotations

from typing import Tuple


def mixture(gen, n: int, dim: int, centers, noise: float, device):
    """*n* rows around the rows of *centers*: a uniform pick of a centre
    plus ``noise`` times a standard normal draw."""
    import torch

    comp = torch.randint(0, centers.shape[0], (n,), generator=gen,
                         device=device)
    return centers[comp] + noise * torch.randn(n, dim, generator=gen,
                                               device=device)


def make(spec: dict, seed: int, device) -> Tuple["torch.Tensor",
                                                 "torch.Tensor"]:
    """(dataset (n_rows, dim), query pool (n_queries, dim)) float32 on
    *device* from *seed*, as the configuration's ``data`` block says."""
    import torch

    if spec["kind"] != "gaussian_mixture":
        raise ValueError(f"unknown data kind {spec['kind']!r}")
    dim = int(spec["dim"])
    fixed = torch.Generator(device=device).manual_seed(
        int(spec["centres_seed"]))
    comps = torch.randn(int(spec["components"]), dim, generator=fixed,
                        device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sigma = float(spec["sigma"])
    x = mixture(gen, int(spec["n_rows"]), dim, comps, sigma, device)
    pool = mixture(gen, int(spec["n_queries"]), dim, comps, sigma, device)
    return x, pool
