"""Host-side parameter grids (port of ``raft_tpu/util/itertools.py``;
reference util/itertools.hpp)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, List


def product_of(**axes: Iterable[Any]) -> List[Dict[str, Any]]:
    """Cartesian product of named axes as a list of dicts, like the
    reference's ``raft::util::itertools::product`` for test grids."""
    keys = list(axes)
    return [dict(zip(keys, vals)) for vals in itertools.product(*axes.values())]
