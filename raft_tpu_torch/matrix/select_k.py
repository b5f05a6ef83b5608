"""Top-k per row (port of ``raft_tpu/matrix/select_k.py``: ``select_k`` with
payload, ``select_min_k`` / ``select_max_k``, ``merge_sorted_runs``,
``merge_sorted_parts``).

The contract is the JAX package's, bit for bit: rows come back best-first,
ties at the lowest position (``jax.lax.top_k``'s stable order — which
``torch.topk`` does not promise, so the plain version sorts a
NaN-sanitized key with ``torch.sort(stable=True)``), NaN ranks as the
worst value, and values are gathered from the raw input by position.
``engine="cuda"`` runs kernel B2 (:mod:`raft_tpu_torch.kernels.select_k`)
where its support predicate holds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.kernels.engine import resolve_engine

#: merge width from which :func:`merge_sorted_runs` takes one stable
#: select over the concatenated runs instead of the O(k²) rank merge
_MERGE_CONCAT_MIN_K = 24


def worst_value(dtype: torch.dtype, select_min: bool):
    """The value that loses every comparison (padding filler)."""
    if dtype.is_floating_point:
        return float("inf") if select_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if select_min else info.min


def _key(values: torch.Tensor, select_min: bool) -> torch.Tensor:
    """Comparison key: NaN replaced by the worst value; half types widened
    to float32 (exact, so order and ties are unchanged)."""
    if not values.dtype.is_floating_point:
        return values
    # exempt(dtype-drift): float64 values keep their type (a check)
    if values.dtype != torch.float32 and values.dtype != torch.float64:
        values = values.float()
    return torch.where(torch.isnan(values),
                       torch.full_like(values, worst_value(values.dtype,
                                                           select_min)),
                       values)


def select_k_plain(values: torch.Tensor, k: int, select_min: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel B2: (values, positions int32)."""
    key = _key(values, select_min)
    _, pos = torch.sort(key, dim=-1, descending=not select_min, stable=True)
    pos = pos[..., :int(k)]
    return torch.gather(values, -1, pos), pos.to(torch.int32)


def select_k(values: torch.Tensor, k: int, select_min: bool = True,
             indices: Optional[torch.Tensor] = None,
             engine: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (or largest) per row, best-first: (values [..., k],
    positions [..., k] int32), or the *indices* payload gathered at those
    positions."""
    if indices is None:
        return _select_k_aot(values, int(k), bool(select_min), None, engine)
    return _select_k_payload_aot(values, indices, int(k), bool(select_min),
                                 engine)


def _select_k_impl(values: torch.Tensor, k: int, select_min: bool,
                   indices: Optional[torch.Tensor], engine: Optional[str]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_k`'s program."""
    from raft_tpu_torch.kernels import select_k as kernel

    engine = resolve_engine("select_k", values.device, engine=engine)
    if (engine == "cuda" and values.numel()
            and kernel.supports(k, values.shape[-1], values.dtype)):
        vals, pos = kernel.select_k_blockwise(values, k, select_min)
    else:
        vals, pos = select_k_plain(values, k, select_min)
    if indices is not None:
        return vals, torch.gather(indices, -1, pos.long())
    return vals, pos


#: ``select_k``'s program, keyed per signature (``raft_tpu/matrix/
#: select_k.py:230`` ``_select_k_aot``; ``core/prewarm.py`` warms it); a
#: call inside another keyed program (an IVF search) runs inline
_select_k_aot = aot(_select_k_impl, static_argnums=(1, 2, 4))


def _select_k_payload_impl(values: torch.Tensor, indices: torch.Tensor,
                           k: int, select_min: bool, engine: Optional[str]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_k`'s program with an id payload."""
    return _select_k_impl(values, k, select_min, indices, engine)


#: the payload select, keyed per signature (``raft_tpu/matrix/
#: select_k.py:231`` ``_select_k_payload_aot``)
_select_k_payload_aot = aot(_select_k_payload_impl, static_argnums=(2, 3, 4))


def merge_sorted_runs(a_vals, a_idx, b_vals, b_idx, k: Optional[int] = None,
                      select_min: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best k of two per-row SORTED runs (select_k outputs), best-first.

    Each element's merged rank is its own position plus the count of the
    other run's elements that beat it; run *a* wins ties, so with run a
    holding the earlier candidates the merge reproduces a stable full sort.
    NaN ranks equal to the worst value; values and ids come from the raw
    runs.  Slots past the union keep the worst value and id -1.  From
    ``k >= 24`` one stable select over the concatenated runs takes over
    (the same result; the rank masks grow with k²)."""
    k = int(a_vals.shape[-1] if k is None else k)
    # exempt(retrace-unbounded-static): k defaults to run a's width, the caller's k
    return _merge_aot(a_vals, a_idx, b_vals, b_idx, k, bool(select_min))


def _merge_sorted_runs_impl(a_vals, a_idx, b_vals, b_idx, k: int,
                            select_min: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`merge_sorted_runs`' program."""
    ka = a_vals.shape[-1]
    kb = b_vals.shape[-1]
    a_key = _key(a_vals, select_min)
    b_key = _key(b_vals, select_min)
    if k >= _MERGE_CONCAT_MIN_K and ka + kb >= k:
        cat_key = torch.cat([a_key, b_key], dim=-1)
        _, pos = torch.sort(cat_key, dim=-1, descending=not select_min,
                            stable=True)
        pos = pos[..., :k]
        return (torch.gather(torch.cat([a_vals, b_vals], -1), -1, pos),
                torch.gather(torch.cat([a_idx, b_idx], -1), -1, pos))
    av = a_key[..., :, None]
    bv = b_key[..., None, :]
    if select_min:
        beats_a = bv < av
        beats_b = av <= bv
    else:
        beats_a = bv > av
        beats_b = av >= bv
    dev = a_vals.device
    rank_a = torch.arange(ka, device=dev) + beats_a.sum(-1)
    rank_b = torch.arange(kb, device=dev) + beats_b.sum(-2)
    lead = tuple(a_vals.shape[:-1])
    # ranks are unique below k; everything ranked k or later lands in a
    # discard slot at position k
    out_v = torch.full(lead + (k + 1,), worst_value(a_vals.dtype, select_min),
                       dtype=a_vals.dtype, device=dev)
    out_i = torch.full(lead + (k + 1,), -1, dtype=a_idx.dtype, device=dev)
    ra = torch.clamp_max(rank_a, k)
    rb = torch.clamp_max(rank_b, k)
    out_v.scatter_(-1, ra, a_vals).scatter_(-1, rb, b_vals.to(a_vals.dtype))
    out_i.scatter_(-1, ra, a_idx).scatter_(-1, rb, b_idx.to(a_idx.dtype))
    return out_v[..., :k], out_i[..., :k]


#: the two-run merge, keyed per signature (``raft_tpu/matrix/
#: select_k.py:236`` ``_merge_aot``): the tiered cold fold and a sharded
#: mutable search's fold dispatch it; a merge inside another keyed program
#: (a tile scan) runs inline
_merge_aot = aot(_merge_sorted_runs_impl, static_argnums=(4, 5))


def select_min_k(values, k: int, indices=None):
    return select_k(values, k, select_min=True, indices=indices)


def select_max_k(values, k: int, indices=None):
    return select_k(values, k, select_min=False, indices=indices)


def merge_sorted_parts(part_vals: torch.Tensor, part_idx: torch.Tensor,
                       k: Optional[int] = None, select_min: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best k of the union of STACKED sorted runs (n_parts, ..., in_k),
    best-first.  The fold seeds from part 0, not from a sentinel carry
    (which would beat real candidates at the sentinel value and give them
    id -1); part 0 is padded with the worst value and id -1 only when
    k > in_k.  Earlier parts win ties, so folding in part order equals a
    stable sort of the concatenated candidates."""
    n_parts, in_k = part_vals.shape[0], part_vals.shape[-1]
    k = int(in_k if k is None else k)
    if in_k >= k:
        best_v, best_i = part_vals[0, ..., :k], part_idx[0, ..., :k]
    else:
        lead = tuple(part_vals.shape[1:-1])
        pad_v = torch.full(lead + (k - in_k,),
                           worst_value(part_vals.dtype, select_min),
                           dtype=part_vals.dtype, device=part_vals.device)
        pad_i = torch.full(lead + (k - in_k,), -1, dtype=part_idx.dtype,
                           device=part_idx.device)
        best_v = torch.cat([part_vals[0], pad_v], dim=-1)
        best_i = torch.cat([part_idx[0], pad_i], dim=-1)
    for j in range(1, n_parts):
        best_v, best_i = merge_sorted_runs(best_v, best_i, part_vals[j],
                                           part_idx[j], k=k,
                                           select_min=select_min)
    return best_v, best_i
