"""Plain reference of an IVF index's build and search (IVF-Flat and
IVF-PQ, squared L2), in blocks so that it fits beside the index.

What it is handed: the raw dataset and queries the benchmark made, and
the index as the program built it, read out as plain tensors (the
``export`` of a benchmark entry): the trained model (coarse centres; for
IVF-PQ the rotation and codebooks) and, for every dataset id, the list
it was stored in and what was stored (IVF-Flat the vector, IVF-PQ the
packed code).  k-means draws its centres from its own seed, so the model
is taken as the program's state; everything after it is worked out
again here: each row's nearest list, each row's code under the model,
the rotated query, the probe choice and every candidate's score.  That
the model itself was trained well is judged apart from it, by recall
against brute force over the raw dataset (``recall_miss``).

Two precisions: ``"float64"`` judges, ``"tf32"`` is the control (float32
with every product's operands rounded to TF32's 10-bit mantissa, as the
tensor cores round them, and float32 sums).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

#: a row's list is off when it is farther than the nearest centre by
#: more than this share of ||x||^2 + max ||c||^2 (float32 rounding of the
#: expanded form is ~1e-7 of it)
TAU_ASSIGN = 1e-5
#: a probe is ambiguous when its coarse distance lies within this share
#: of ||q||^2 + max ||c||^2 of the last probe's
TAU_PROBE = 1e-5
#: a code is off when its codeword is farther from the rotated residual
#: than the nearest by more than this share of ||r_s||^2 + ||cb||^2
TAU_CODE = 1e-4
ROWS = 1 << 13


def tf32(t: torch.Tensor) -> torch.Tensor:
    """*t* rounded to TF32 (10 mantissa bits, to nearest)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _cast(t: torch.Tensor, mode: str) -> torch.Tensor:
    return t.double() if mode == "float64" else t.float()


def dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b.T in *mode*."""
    if mode == "float64":
        return a.double() @ b.double().T
    if mode == "tf32":
        return tf32(a) @ tf32(b).T
    raise ValueError(f"unknown precision {mode!r}")


def sq_dist(a: torch.Tensor, b: torch.Tensor, mode: str,
            bn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared L2 distances (rows of a, rows of b) by the expanded form."""
    a_ = _cast(a, mode)
    an = (a_ * a_).sum(1)
    if bn is None:
        b_ = _cast(b, mode)
        bn = (b_ * b_).sum(1)
    return an[:, None] + bn[None, :] - 2.0 * dot(a, b, mode)


def unpack_codes(packed: torch.Tensor, pq_dim: int,
                 pq_bits: int) -> torch.Tensor:
    """(n, bytes) LSB-first bitstream -> (n, pq_dim) int64 codes."""
    if pq_bits == 8:
        return packed[:, :pq_dim].long()
    bits = ((packed.long()[:, :, None] >> torch.arange(
        8, device=packed.device)) & 1).reshape(packed.shape[0], -1)
    w = 1 << torch.arange(pq_bits, device=packed.device)
    return (bits[:, :pq_dim * pq_bits].reshape(-1, pq_dim, pq_bits)
            * w).sum(-1)


class Index:
    """The index as the reference reads it (see the module doc).

    ``labels`` (n,) int64 list of each dataset id, -1 where the program
    stored none; ``stored`` (n, dim) float32 (IVF-Flat) or ``codes`` (n,
    pq_dim) int64 (IVF-PQ); ``duplicates``: ids the program stored more
    than once."""

    def __init__(self, exp: Dict[str, object]):
        self.kind = exp["kind"]
        self.centers = exp["centers"]
        self.labels = exp["labels"].long()
        self.duplicates = int(exp["duplicates"])
        self.n_lists = self.centers.shape[0]
        if self.kind == "ivf_pq":
            self.rotation = exp["rotation"]
            self.codebooks = exp["codebooks"]       # (pq_dim, 2^bits, ds)
            self.pq_dim = self.codebooks.shape[0]
            self.codes = unpack_codes(exp["codes"], self.pq_dim,
                                      int(exp["pq_bits"]))
        else:
            self.stored = exp["stored"]

    def rows(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        """The vectors the search scores, in the query's space: IVF-Flat
        the dataset's rows; IVF-PQ each row's reconstruction, its list's
        rotated centre plus its decoded codewords."""
        if self.kind != "ivf_pq":
            return _cast(x, mode)
        rc = dot(self.centers, self.rotation.T, mode)     # centres @ R
        lab = self.labels.clamp_min(0)
        out = torch.empty((x.shape[0], self.rotation.shape[1]),
                          dtype=rc.dtype, device=x.device)
        cb = _cast(self.codebooks, mode)
        sub = torch.arange(self.pq_dim, device=x.device)
        for r0 in range(0, x.shape[0], ROWS * 8):
            c = self.codes[r0:r0 + ROWS * 8]
            dec = cb[sub[None, :], c].reshape(c.shape[0], -1)
            out[r0:r0 + ROWS * 8] = rc[lab[r0:r0 + ROWS * 8]] + dec
        return out

    def query_space(self, q: torch.Tensor, mode: str) -> torch.Tensor:
        if self.kind != "ivf_pq":
            return _cast(q, mode)
        return dot(q, self.rotation.T, mode)


def build_checks(x: torch.Tensor, idx: Index) -> Dict[str, int]:
    """Counts of what the build got wrong, each 0 for a sound index:
    ``ids_off`` (ids stored never or twice), ``lists_off`` (rows not in
    their nearest list, ties within ``TAU_ASSIGN`` aside) and
    ``rows_off`` (IVF-Flat: stored vectors not bit for bit the row) or
    ``codes_off`` (IVF-PQ: codes not the nearest codeword of the rotated
    residual, ties within ``TAU_CODE`` aside)."""
    n = x.shape[0]
    out = {"ids_off": int((idx.labels < 0).sum()) + idx.duplicates}
    cn = (idx.centers.double() ** 2).sum(1)
    lists_off = 0
    codes_off = 0
    for r0 in range(0, n, ROWS):
        xb = x[r0:r0 + ROWS]
        lb = idx.labels[r0:r0 + ROWS]
        ok = lb >= 0
        d = sq_dist(xb, idx.centers, "float64", bn=cn)
        got = d.gather(1, lb.clamp_min(0)[:, None])[:, 0]
        tau = TAU_ASSIGN * ((xb.double() ** 2).sum(1) + cn.max())
        lists_off += int(((got - d.min(1).values > tau) & ok).sum())
        if idx.kind == "ivf_pq":
            r = (xb.double() - idx.centers.double()[lb.clamp_min(0)]) \
                @ idx.rotation.double()
            cb = idx.codebooks.double()                 # (m, kcb, ds)
            rs = r.reshape(r.shape[0], idx.pq_dim, -1)   # (b, m, ds)
            rn = (rs * rs).sum(-1)
            cbn = (cb * cb).sum(-1)                     # (m, kcb)
            dd = (rn[:, :, None] + cbn[None]
                  - 2.0 * torch.einsum("bmd,mkd->bmk", rs, cb))
            c = idx.codes[r0:r0 + ROWS]
            got_c = dd.gather(2, c[:, :, None])[:, :, 0]
            tau_c = TAU_CODE * (rn + cbn.gather(
                1, c.T).T)
            bad = (got_c - dd.min(2).values > tau_c).any(1) & ok
            codes_off += int(bad.sum())
    out["lists_off"] = lists_off
    if idx.kind == "ivf_pq":
        out["codes_off"] = codes_off
    else:
        out["rows_off"] = int(((idx.stored != x).any(1)
                               & (idx.labels >= 0)).sum())
    return out


def coarse(q: torch.Tensor, idx: Index, mode: str) -> torch.Tensor:
    return sq_dist(q, idx.centers, mode)


def search(q: torch.Tensor, x: torch.Tensor, idx: Index, n_probes: int,
           k: int, mode: str, rows: Optional[torch.Tensor] = None,
           block: int = 128):
    """The reference's own answer: the *n_probes* nearest lists, the k
    best rows of those lists by the index's score.  (distances (nq, k),
    ids (nq, k))."""
    y = idx.rows(x, mode) if rows is None else rows
    yn = (y * y).sum(1)
    out_d, out_i = [], []
    for b0 in range(0, q.shape[0], block):
        qb = q[b0:b0 + block]
        probes = coarse(qb, idx, mode).topk(n_probes, 1,
                                            largest=False).indices
        allowed = torch.zeros((qb.shape[0], idx.n_lists), dtype=torch.bool,
                              device=q.device)
        allowed.scatter_(1, probes, True)
        qs = idx.query_space(qb, mode)
        d = sq_dist(qs, y, mode, bn=yn)
        d = torch.where(allowed[:, idx.labels.clamp_min(0)]
                        & (idx.labels >= 0)[None], d,
                        torch.full_like(d, float("inf")))
        v, i = d.topk(k, 1, largest=False)
        out_d.append(v)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def judge(q: torch.Tensor, x: torch.Tensor, idx: Index, n_probes: int,
          got_d: torch.Tensor, got_i: torch.Tensor,
          rows: Optional[torch.Tensor] = None, block: int = 128
          ) -> Dict[str, float]:
    """Hold answers (distances, ids) of the queries *q* to the float64
    reference.  ``gap``: the widest of (a) the gap at each rank between
    the answer's distance and the reference's best over the probed lists
    and (b) the gap between an answer's distance and the reference's
    score of the id it names, as a share of ||q||^2 + mean ||x||^2.  A
    probe within ``TAU_PROBE`` of the last one is ambiguous: then the
    rank's distance has to lie between the reference's best with and
    without the ambiguous lists.  ``answers_off``: answers whose distance
    is not finite, or whose id is out of range, repeated in a row, or
    from a list no probe choice takes (such an answer has no gap of its
    own; a rank whose probed lists hold fewer than its rank's rows in the
    reference has none either).  ``recall_miss``: the share of the exact
    k nearest rows, by brute force over the raw dataset, that the answers
    miss: the one number that owes nothing to the program's trained
    model."""
    k = got_i.shape[1]
    y = idx.rows(x, "float64") if rows is None else rows
    yn = (y * y).sum(1)
    x64 = x.double()
    xn = (x64 * x64).sum(1)
    mean_xn = xn.mean()
    cmax = (idx.centers.double() ** 2).sum(1).max()
    live = (idx.labels >= 0)[None]
    lab = idx.labels.clamp_min(0)
    gap = torch.zeros((), dtype=torch.float64, device=q.device)
    off, hits = 0, 0
    inf = float("inf")
    for b0 in range(0, q.shape[0], block):
        qb = q[b0:b0 + block]
        gd = got_d[b0:b0 + block].double()
        gi = got_i[b0:b0 + block].long()
        qn = (qb.double() ** 2).sum(1)
        cd = coarse(qb, idx, "float64")
        last = cd.topk(n_probes, 1, largest=False).values[:, -1:]
        tau = TAU_PROBE * (qn + cmax)[:, None]
        inside = cd < last - tau
        band = (cd - last).abs() <= tau
        exact = (inside.sum(1) + band.sum(1)) == n_probes
        lo_lists = inside | band
        hi_lists = torch.where(exact[:, None], lo_lists, inside)
        d = sq_dist(idx.query_space(qb, "float64"), y, "float64", bn=yn)
        lo = torch.where(lo_lists[:, lab] & live, d, torch.full_like(d, inf))
        hi = torch.where(hi_lists[:, lab] & live, d, torch.full_like(d, inf))
        d_lo = lo.topk(k, 1, largest=False).values
        d_hi = hi.topk(k, 1, largest=False).values
        valid = (gi >= 0) & (gi < x.shape[0])
        gi0 = gi.clamp(0, x.shape[0] - 1)
        own = lo.gather(1, gi0)            # inf: from a list never probed
        srt = gi.sort(1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bad = ~valid | dup | torch.isinf(own) | ~torch.isfinite(gd)
        off += int(bad.sum())
        scale = (qn + mean_xn)[:, None]
        zero = torch.zeros_like(gd)
        # the reference's inf: fewer than k rows in the probed lists
        below = torch.where(torch.isinf(d_lo), zero, d_lo - gd)
        above = torch.where(torch.isinf(d_hi), zero, gd - d_hi)
        rank = torch.maximum(below, above).clamp_min(0.0)
        g = torch.where(bad, zero,
                        torch.maximum(rank, (gd - own).abs()) / scale)
        # torch.maximum keeps a NaN, so a NaN gap fails its limit
        gap = torch.maximum(gap, g.max())
        # exact neighbours by the true distance, for recall
        de = sq_dist(qb, x64, "float64", bn=xn)
        truth = de.topk(k, 1, largest=False).indices
        hits += int((gi[:, :, None] == truth[:, None, :]).any(2).sum())
    return {"gap": float(gap), "answers_off": off,
            "recall_miss": 1.0 - hits / max(1, got_i.numel())}
