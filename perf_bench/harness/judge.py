"""The comparison that decides ``correct``.

Once the window has closed, the answers the timed path gave are held to
the plain reference (``perf_bench/reference``):

- the index the set-up built (:func:`reference.ivf.build_checks`);
- every answer the window produced: closed loop, every row of one call
  drawn from the seed, and every other call's answers equal to that
  call's bit for bit (``calls_differ``); open loop, every pool row that
  some request was served, by its first answer, and every other serving
  of the same row answered alike (``rows_differ``);
- ``unanswered``: requests that never came back.

Each number has its limit in the configuration's ``check.limits``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perf_bench.reference import ivf


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), 17])


def closed_answers(calls: List[Tuple[np.ndarray, np.ndarray]],
                   rows: np.ndarray, seed: int):
    """(pool rows, distances, ids) of every row of one call drawn from the
    seed, and the number of calls whose answers differ from its."""
    c = int(_rng(seed).integers(len(calls)))
    d, i = calls[c]
    differ = sum(1 for dd, ii in calls
                 if not (np.array_equal(dd, d) and np.array_equal(ii, i)))
    return rows, d, i, differ


def open_answers(results: list, rows: List[np.ndarray]):
    """(pool rows, distances, ids) of every pool row some request was
    served, each with its first answer, and the number of served rows
    whose answer differs from the first serving of the same pool row."""
    served = [j for j, r in enumerate(results) if isinstance(r, tuple)]
    if not served:
        return np.zeros(0, np.int64), None, None, 0
    r_all = np.concatenate([rows[j] for j in served])
    d_all = np.concatenate([results[j][0] for j in served])
    i_all = np.concatenate([results[j][1] for j in served])
    srt = np.argsort(r_all, kind="stable")
    head = np.r_[True, r_all[srt][1:] != r_all[srt][:-1]]
    first = srt[np.maximum.accumulate(np.where(head, np.arange(len(srt)),
                                               0))]
    differ = int(((d_all[srt] != d_all[first]).any(1)
                  | (i_all[srt] != i_all[first]).any(1)).sum())
    uniq = srt[head]
    return r_all[uniq], d_all[uniq], i_all[uniq], differ


def numbers(cfg: dict, x: torch.Tensor, pool: torch.Tensor, export: dict,
            q_rows: np.ndarray, got_d, got_i) -> Dict[str, float]:
    """The reference's readings of the index and of the sampled answers."""
    idx = ivf.Index(export)
    out = dict(ivf.build_checks(x, idx))
    dev = x.device
    q = pool[torch.as_tensor(q_rows, device=dev).long()]
    out.update(ivf.judge(q, x, idx, int(cfg["search"]["n_probes"]),
                         torch.as_tensor(got_d, device=dev),
                         torch.as_tensor(got_i, device=dev)))
    return out


def control(cfg: dict, x: torch.Tensor, pool: torch.Tensor, export: dict,
            q_rows: np.ndarray) -> Dict[str, float]:
    """The control: the reference's own search in TF32, put in the
    program's place for the same queries, and judged as the program is."""
    idx = ivf.Index(export)
    q = pool[torch.as_tensor(q_rows, device=x.device).long()]
    d, i = ivf.search(q, x, idx, int(cfg["search"]["n_probes"]),
                      int(cfg["k"]), "tf32")
    return ivf.judge(q, x, idx, int(cfg["search"]["n_probes"]), d, i)


def verdict(found: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) — each number found against
    its limit; a number without a limit fails (a limit may name a number
    that only the other kind of loop reads)."""
    shown, ok = {}, True
    for name, value in found.items():
        limit = limits.get(name)
        shown[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, shown
