"""The port's containers (``raft_tpu_torch.core.mdarray``) against
raft_tpu's on the CPU: memory types and layouts, extents and the logical
orientation of column-major data, the factories, ``as_device_array`` and
the checks; device memory is the handle's device (a CPU handle here),
host memory a CPU tensor."""

import numpy as np
import pytest
import torch

import raft_tpu.core.mdarray as jmd
import raft_tpu_torch.core.mdarray as tmd
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.core.handle import Handle


@pytest.fixture(scope="module")
def cpu():
    return Handle(device="cpu")


def test_enums_match():
    assert [m.value for m in tmd.MemoryType] == [m.value for m in
                                                 jmd.MemoryType]
    assert [m.value for m in tmd.Layout] == [m.value for m in jmd.Layout]
    assert tmd.row_major is tmd.Layout.C and tmd.col_major is tmd.Layout.F


@pytest.mark.parametrize("layout", ["C", "F"])
def test_views(layout):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    buf = a.T.copy() if layout == "F" else a
    t = tmd.MdArray(torch.from_numpy(buf), tmd.MemoryType.HOST,
                    tmd.Layout[layout])
    j = jmd.MdArray(buf, jmd.MemoryType.HOST, jmd.Layout[layout])
    assert t.shape == j.shape == (3, 4)
    assert t.extent(1) == j.extent(1) and t.size() == j.size() == 12
    assert t.ndim == j.ndim == 2
    assert np.array_equal(np.asarray(t), np.asarray(j))
    assert np.array_equal(np.asarray(t, dtype=np.float64), a)
    assert torch.equal(t.logical(), torch.from_numpy(a))
    v = t.view()
    assert type(v) is tmd.MdSpan and v.data is t.data
    assert (v.memory_type, v.layout) == (t.memory_type, t.layout)


@pytest.mark.parametrize("layout", ["C", "F"])
def test_factories(cpu, layout):
    lay, jlay = tmd.Layout[layout], jmd.Layout[layout]
    pairs = [
        (tmd.make_device_vector(cpu, 7), jmd.make_device_vector(None, 7)),
        (tmd.make_device_matrix(cpu, 3, 5, np.int32, lay),
         jmd.make_device_matrix(None, 3, 5, np.int32, jlay)),
        (tmd.make_device_mdarray(cpu, (2, 3, 4), np.float64),
         jmd.make_device_mdarray(None, (2, 3, 4), np.float64)),
        (tmd.make_device_scalar(cpu, 2.5, np.float32),
         jmd.make_device_scalar(None, 2.5, np.float32)),
        (tmd.make_host_vector(4), jmd.make_host_vector(4)),
        (tmd.make_host_matrix(2, 6, np.float32, lay),
         jmd.make_host_matrix(2, 6, np.float32, jlay)),
        (tmd.make_host_scalar(3, np.int64), jmd.make_host_scalar(3, np.int64)),
    ]
    for t, j in pairs:
        assert t.shape == j.shape and t.layout.value == j.layout.value
        assert t.memory_type.value == j.memory_type.value
        assert np.array_equal(np.asarray(t), np.asarray(j))
        assert np.asarray(t).dtype == np.asarray(j).dtype
        assert t.data.device.type == "cpu"
    # host memory is pinned only where a card is present
    assert tmd.make_host_vector(4).data.is_pinned() \
        == torch.cuda.is_available()


def test_as_device_array(cpu):
    x = np.arange(6).reshape(2, 3)
    got = tmd.as_device_array(x, dtype=np.float32, handle=cpu)
    want = jmd.as_device_array(x, dtype=np.float32)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    span = tmd.MdSpan(torch.from_numpy(x.T.copy()), layout=tmd.Layout.F)
    assert np.array_equal(tmd.as_device_array(span, handle=cpu).numpy(), x)
    assert tmd.as_device_array(torch.ones(2, dtype=torch.float64),
                               torch.float32, cpu).dtype == torch.float32
    assert np.array_equal(tmd.as_device_array([1, 2], handle=cpu).numpy(),
                          [1, 2])


def test_checks():
    tmd.expect_matrix(torch.zeros(2, 3))
    with pytest.raises(LogicError, match="2-d"):
        tmd.expect_matrix(torch.zeros(3), "x")
    tmd.expect_same_dtype(torch.zeros(2), torch.ones(3))
    with pytest.raises(LogicError, match="dtype mismatch"):
        tmd.expect_same_dtype(torch.zeros(2), torch.zeros(2,
                                                          dtype=torch.int32))


def test_device_memory_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmd.make_device_vector(None, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmd.as_device_array(np.zeros(3))
