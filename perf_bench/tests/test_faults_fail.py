"""A run whose timed path is broken underneath comes out as not correct,
for each fault a search cell can have on one card: an answer altered
where it is produced, half of a batch left out (its rows answered with
the other half's answers), a step that returns its state unchanged (the
output buffers as they were: zeros), and distances that overflow to
infinity beside the right ids.  A cell on one card has no exchange
between chips to leave out."""

import types
from concurrent import futures

import pytest
import torch

from perf_bench.tests import tiny


def _altered(d, i):
    i = i.clone()
    i[0, 0] = (i[0, 0] + 1) % 4000
    return d, i


def _half(d, i):
    h = (d.shape[0] + 1) // 2
    d, i = d.clone(), i.clone()
    d[h:], i[h:] = d[:d.shape[0] - h], i[:i.shape[0] - h]
    return d, i


def _unchanged(d, i):
    return torch.zeros_like(d), torch.zeros_like(i)


def _inf(d, i):
    return torch.full_like(d, float("inf")), i


FAULTS = {"answer_altered": _altered, "half_left_out": _half,
          "state_unchanged": _unchanged, "inf_distances": _inf}


class _Server:
    """The entry's server with *fault* applied to the second answer and
    every later one."""

    def __init__(self, inner, fault):
        self.inner, self.fault, self.n = inner, fault, 0
        self.engine = inner.engine

    def submit(self, q):
        out = futures.Future()
        self.n += 1
        broken = self.n > 1 and q.shape[0] > 1

        def done(f):
            d, i = f.result()
            if broken:
                d, i = self.fault(torch.as_tensor(d), torch.as_tensor(i))
                d, i = d.numpy(), i.numpy()
            out.set_result((d, i))

        self.inner.submit(q).add_done_callback(done)
        return out

    def close(self):
        self.inner.close()


def _broken_entry(real, fault):
    calls = {"n": 0}

    def call(system, q):
        calls["n"] += 1
        d, i = real.call(system, q)
        return fault(d, i) if calls["n"] > 1 else (d, i)

    return types.SimpleNamespace(
        prepare=real.prepare, build=real.build, call=call,
        dispatches_per_call=real.dispatches_per_call, export=real.export,
        serve=lambda system, mb: _Server(real.serve(system, mb), fault))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["ivf_pq-sift1m.batch",
                                      "ivf_flat-sift1m.open"])
def test_broken_timed_path_is_not_correct(workload, fault):
    c = tiny.cell_of(workload)
    out = tiny.run(c, seconds=0.3,
                   entry=_broken_entry(c.entry(), FAULTS[fault]))
    assert out["correct"] is False, out["check"]


def test_sound_timed_path_is_correct():
    c = tiny.cell_of("ivf_flat-sift1m.open")
    assert tiny.run(c, seconds=0.3)["correct"]
