"""Kernel B6 (the compile probe, ``raft_tpu_torch.kernels.probe``) and the
build order it relies on, on the CPU.

B6's plain version is held to the TPU kernel it replaces — the same
three-line ``add_one`` body as ``bench/tpu_session.py:357``, run here
through ``pl.pallas_call(..., interpret=True)`` (``bench.tpu_session`` is
not imported: it opens its output file and sets environment variables at
import) — exactly.  The kernel itself runs only on the card
(``tests/test_torch_cuda_dense.py``); here it raises on a CPU tensor, and
:func:`probe` records that as a failed case with its error text.  The
loader is driven with a stand-in ``nvcc`` script: ``library(name)``
compiles its own source alone, ``load_all`` every missing one, and a
failed build raises with the compiler's whole output.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.kernels import native, probe


def _pallas_add_one(x):
    def add_one(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    return pl.pallas_call(
        add_one, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x)


@pytest.mark.parametrize("kind", ["zeros", "seeded", "extremes"])
def test_add_one_plain_is_the_tpu_kernel(kind):
    shape = probe.ADD_ONE_SHAPE
    if kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "seeded":
        x = np.random.default_rng(16).standard_normal(shape).astype(
            np.float32) * 1e3
    else:
        x = np.full(shape, -1.0, np.float32)
        x[0, :4] = [np.float32(2 ** 24), -np.float32(2 ** 24), np.inf,
                    np.float32(1e-30)]
        x[1, :3] = [np.finfo(np.float32).max, -np.inf, np.nan]
    want = np.asarray(_pallas_add_one(jnp.asarray(x)))
    got = probe.add_one_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)


def test_add_one_takes_cuda_tensors_only():
    before = native.LAUNCHES["add_one"]
    with pytest.raises(LogicError, match="CUDA tensor"):
        probe.add_one(torch.zeros(probe.ADD_ONE_SHAPE))
    assert native.LAUNCHES["add_one"] == before      # no launch counted
    assert native.SOURCES[0] == "probe"
    assert (native.CSRC / "probe.cu").is_file()


def test_probe_on_the_host_records_the_failed_case():
    before = native.LAUNCHES["add_one"]
    rows = probe.probe("cpu")
    assert [r["case"] for r in rows] == ["trivial_add", "fused_l2nn_small"]
    assert rows[0]["ok"] is False
    assert "kernel B6 takes a CUDA tensor" in rows[0]["error"]
    # case (b) on the host runs B1's plain version against itself
    assert rows[1]["ok"] is True and rows[1]["mismatched_ids"] == 0
    assert rows[1]["shape"] == [1024, 256, 128]
    assert native.LAUNCHES["add_one"] == before


def test_probe_needs_a_card_when_asked_for_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.probe()


_FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    *.cu) src="$1"; shift ;;
    *) shift ;;
  esac
done
echo "$src" >> "$LOG"
case "$src" in
  *"$FAIL"*) echo "$src(3): error: identifier \\"broken\\" is undefined"
             echo "1 error detected in the compilation of $src."
             exit 2 ;;
esac
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    script = tmp_path / "nvcc"
    script.write_text(_FAKE_NVCC)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "log"
    monkeypatch.setenv("LOG", str(log))
    monkeypatch.setenv("FAIL", "no-such-source")
    monkeypatch.setattr(native, "_nvcc", lambda: str(script))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_libs", {})

    def compiled():
        if not log.exists():
            return []
        return [os.path.basename(p) for p in log.read_text().split()]

    return compiled


def test_build_of_one_source_compiles_it_alone(fake_nvcc, monkeypatch):
    before = native.BUILDS["compiled"]
    native.build_all(("probe",))
    assert fake_nvcc() == ["probe.cu"]
    assert native._target("probe").exists()
    native.build_all(("probe",))                     # built: nothing to do
    assert fake_nvcc() == ["probe.cu"]
    # library() builds only its own source (the load itself then fails
    # on the stand-in's output, which is no library)
    with pytest.raises(OSError):
        native.library("select_k")
    assert fake_nvcc() == ["probe.cu", "select_k.cu"]
    native.build_all()                               # the rest, at once
    assert sorted(fake_nvcc()) == sorted(f"{s}.cu" for s in native.SOURCES)
    assert native.BUILDS["compiled"] - before == len(native.SOURCES)
    with pytest.raises(ValueError, match="no kernel source"):
        native.build_all(("nope",))


def test_failed_build_raises_with_the_compilers_output(fake_nvcc,
                                                       monkeypatch):
    monkeypatch.setenv("FAIL", "probe.cu")
    with pytest.raises(RuntimeError) as err:
        native.library("probe")
    text = str(err.value)
    assert "nvcc failed" in text and "probe.cu:" in text
    assert 'identifier "broken" is undefined' in text
    assert "1 error detected in the compilation" in text
    assert fake_nvcc() == ["probe.cu"]               # nothing else built
    assert not native._target("probe").exists()
