"""Each cell end to end on the card through ``run.py``, at a short
window: exit 0, the contract's last line, ``correct`` true.  Skips where
there is no CUDA card (decided inside the test)."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["ivf_pq-sift1m.batch",
                                      "ivf_flat-sift1m.open"])
def test_cell_runs_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "perf_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
    if trace:
        assert res["device"]["busy_s"] > 0
