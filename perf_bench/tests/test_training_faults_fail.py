"""A run whose index was trained wrong comes out as not correct.

``faults.py`` plants training faults that leave the index consistent
with its own model, so that every number the reference re-derives under
that model reads sound; ``recall_miss``, against brute force over the raw
dataset, has to catch them.  At this size the faults below read well
apart from sound runs (``tiny.RECALL_MISS``); on the card
``control.py --fault`` reads every fault at the cells' own sizes."""

import pytest

from perf_bench import faults
from perf_bench.tests import tiny

CASES = [("ivf_flat-sift1m.open", "coarse_untrained"),
         ("ivf_pq-sift1m.batch", "coarse_untrained"),
         ("ivf_pq-sift1m.batch", "codebooks_random"),
         ("ivf_pq-sift1m.batch", "rotation_not_orthonormal")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_training_fault_is_not_correct(workload, fault):
    c = tiny.cell_of(workload)
    with faults.planted(fault, c.config):
        out = tiny.run(c, seconds=0.3)
    check = out["check"]
    assert out["correct"] is False, check
    assert check["recall_miss"]["value"] > check["recall_miss"]["limit"]
    assert check["gap"]["value"] <= check["gap"]["limit"]


def test_planted_fault_is_taken_out_again():
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    before = (ivf_pq.build_hierarchical, ivf_flat.build_hierarchical,
              ivf_pq._train_codebooks_subspace)
    c = tiny.cell_of("ivf_pq-sift1m.batch")
    with faults.planted("coarse_untrained", c.config):
        assert ivf_pq.build_hierarchical is not before[0]
    assert (ivf_pq.build_hierarchical, ivf_flat.build_hierarchical,
            ivf_pq._train_codebooks_subspace) == before
