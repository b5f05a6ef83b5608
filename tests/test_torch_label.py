"""The port's label utilities (``raft_tpu_torch.label``) against raft_tpu
on the CPU, on the same seeded labels: unique labels, one-vs-rest,
``make_monotonic`` (the native path for host labels, the searchsorted
path with given uniques) and ``merge_labels`` over a grid of class counts
and mask shares, exactly."""

import numpy as np
import pytest
import torch

import raft_tpu.label as jlab
import raft_tpu_torch.label as tlab
from raft_tpu_torch import native
from raft_tpu_torch.core.error import LogicError


def labels(seed, n=300, spread=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(-spread, spread, n) * 7).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_unique_and_ovr(seed):
    lab = labels(seed)
    same = np.array_equal
    assert same(tlab.get_unique_labels(lab, device="cpu").numpy(),
                np.asarray(jlab.get_unique_labels(lab)))
    assert same(tlab.get_unique_labels(torch.from_numpy(lab)).numpy(),
                np.asarray(jlab.get_unique_labels(lab)))
    target = int(lab[3])
    for tv, fv in ((1, 0), (5, -2)):
        assert same(tlab.get_ovr_labels(lab, target, tv, fv,
                                        device="cpu").numpy(),
                    np.asarray(jlab.get_ovr_labels(lab, target, tv, fv)))


@pytest.mark.parametrize("zero_based", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_monotonic(seed, zero_based):
    lab = labels(seed)
    want = np.asarray(jlab.make_monotonic(lab, zero_based=zero_based))
    # host labels: the native runtime; an array's result goes to device=
    got = tlab.make_monotonic(lab, zero_based=zero_based, device="cpu")
    assert np.array_equal(got.numpy(), want)
    got = tlab.make_monotonic(torch.from_numpy(lab), zero_based=zero_based)
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
    # given uniques: the searchsorted path
    uniq = np.unique(lab)
    got = tlab.make_monotonic(torch.from_numpy(lab), torch.from_numpy(uniq),
                              zero_based)
    want_u = np.asarray(jlab.make_monotonic(lab, uniq, zero_based))
    assert np.array_equal(got.numpy(), want_u)


def test_make_monotonic_takes_the_native_path(monkeypatch):
    calls = []
    real = native.make_monotonic

    def spy(labels, zero_based=True):
        calls.append(len(labels))
        return real(labels, zero_based)

    monkeypatch.setattr(native, "make_monotonic", spy)
    lab = labels(3)
    tlab.make_monotonic(lab, device="cpu")
    tlab.make_monotonic(torch.from_numpy(lab))
    assert calls == [300, 300]

    def broken(labels, zero_based=True):
        raise native.NativeBuildError("g++ exited 1")

    # a failed native build raises: there is no quiet fallback
    monkeypatch.setattr(native, "make_monotonic", broken)
    with pytest.raises(native.NativeBuildError):
        tlab.make_monotonic(lab, device="cpu")


@pytest.mark.parametrize("n,n_classes,mask_frac,seed", [
    (10, 3, 0.5, 0), (100, 10, 0.3, 1), (300, 40, 0.5, 2),
    (300, 5, 0.2, 4), (257, 257, 0.5, 5), (50, 7, 0.0, 6),
    (120, 120, 1.0, 7)])
def test_merge_labels(n, n_classes, mask_frac, seed):
    rng = np.random.default_rng(seed)
    la = rng.integers(0, n_classes, n).astype(np.int32)
    lb = rng.integers(0, n_classes, n).astype(np.int32)
    mask = rng.random(n) < mask_frac
    want = np.asarray(jlab.merge_labels(la, lb, mask))
    got = tlab.merge_labels(la, lb, mask, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    got = tlab.merge_labels(torch.from_numpy(la), torch.from_numpy(lb),
                            torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)


def test_merge_labels_rejects_out_of_range_ids():
    la = np.array([0, 0, 1, 1, 2, 2], np.int32)
    mask = np.ones(6, bool)
    with pytest.raises(LogicError, match="labels_b"):
        tlab.merge_labels(la, np.array([7, 7, 7, 8, 8, 8], np.int32), mask,
                          device="cpu")
    with pytest.raises(LogicError, match="labels_a"):
        tlab.merge_labels(la * 3 + 5, la, mask, device="cpu")
    lb = np.array([0, 0, 99, 99, 1, 1], np.int32)   # unmasked: never read
    m2 = np.array([True, True, False, False, True, True])
    assert np.array_equal(
        tlab.merge_labels(la, lb, m2, device="cpu").numpy(),
        np.asarray(jlab.merge_labels(la, lb, m2)))
    assert tlab.merge_labels(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, bool), device="cpu").shape == (0,)
