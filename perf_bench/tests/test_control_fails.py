"""The control of ``correct`` comes out as not correct: the reference's
own search in TF32, put in the program's place, reads a ``gap`` over the
configuration's limit, where the program's stays under it.  (On the card
``perf_bench/control.py`` reads both at the cells' own sizes.)"""

import pytest

from perf_bench.tests import tiny


@pytest.mark.parametrize("workload", ["ivf_pq-sift1m.batch",
                                      "ivf_flat-sift1m.open"])
def test_tf32_control_fails_where_the_program_passes(workload):
    c = tiny.cell_of(workload)
    out = tiny.run(c, seconds=0.3, control=True)
    limit = c.config["check"]["limits"]["gap"]
    assert out["correct"], out["check"]
    assert out["check"]["gap"]["value"] < limit / 10
    assert out["control"]["gap"] > limit
