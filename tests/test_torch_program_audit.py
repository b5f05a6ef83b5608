"""The port's program audit and golden fingerprints
(``raft_tpu_torch/analysis/program_audit.py``, ``fingerprint.py``) — the
counterparts of ``raft_tpu/analysis/hlo_audit.py`` / ``fingerprint.py``:
one entry per reference program, every budget met on the CPU, the
committed CPU goldens diff clean at head, and seeded regressions — an
extra collective, a float64 upcast, a lost in-place write — each fail
while op jitter within tolerance passes (as
``tests/test_lowering_locks.py::TestSeededRegressions`` seeds the JAX
package's)."""

import copy
import io
import json
import pathlib

import pytest
import torch

from raft_tpu_torch.analysis import fingerprint, program_audit, registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_GOLDENS = ROOT / "raft_tpu" / "analysis" / "goldens"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def records():
    """One audit run of every registered program on the CPU (the four
    world-1 programs in a process of their own)."""
    return program_audit.measure_all(registry.iter_programs(), CPU)


def test_one_entry_per_reference_program():
    want = sorted(p.stem for p in REFERENCE_GOLDENS.glob("*.json"))
    got = sorted(e.name for e in registry.iter_programs())
    assert got == want and len(got) == 17


def test_entries_declare_notes_and_world_one():
    for e in registry.iter_programs():
        assert e.notes, e.name
        assert e.comms == e.name.startswith("ann_mnmg."), e.name
        if e.comms:
            assert e.collectives == 1 and not e.fast


def test_every_program_runs_within_budget(records):
    for e in registry.iter_programs():
        rec = records[e.name]
        assert "error" not in rec, rec
        assert program_audit.check(e, rec) == [], (e.name, rec)
        assert rec["transient_bytes"] is None        # skipped on the CPU


def test_hot_programs_make_no_host_syncs(records):
    """Zero where the reference had zero: no program of the registry reads
    the device back."""
    assert {n: r["host_reads"] for n, r in records.items()
            if r["host_reads"]} == {}


def test_world_one_programs_make_one_allgather(records):
    for name in ("ann_mnmg.ivf_flat_sharded", "ann_mnmg.ivf_pq_sharded",
                 "ann_mnmg.brute_force_sharded",
                 "ann_mnmg.ivf_flat_replica_group"):
        assert records[name]["collectives"] == 1
        assert records[name]["collective_bytes"] == 64 * 16 * 4


def test_in_place_program_aliases_its_inputs(records):
    rec = records["build.scatter_append_in_place"]
    assert rec["in_place"] == rec["in_place_expected"] == [[0, 0], [1, 0]]


def test_programs_are_the_declared_functions():
    """The decorator registers the hot function itself and returns it
    unchanged; its inputs come from ``analysis/programs.py``, one builder
    per declared name."""
    from raft_tpu_torch.analysis import programs
    from raft_tpu_torch.neighbors import brute_force

    entries = registry.iter_programs()
    assert sorted(programs.BUILDERS) == sorted(e.name for e in entries)
    e = registry.get_program("brute_force.knn_scan")
    assert e.builder.fn is brute_force._knn_scan_aot._fn
    assert e.builder(CPU)["fn"] is e.builder.fn


def test_kernel_programs_are_held_against_plain(records):
    """Every program that launches a kernel on the card (its committed
    card golden lists launches) declares a plain version, and on the CPU
    the run agrees with it."""
    card = [p for p in fingerprint.GOLDEN_DIR.iterdir()
            if p.name.startswith("NVIDIA")]
    assert card
    launching = sorted(
        f.stem for f in card[0].glob("*.json")
        if json.loads(f.read_text())["launches"])
    assert len(launching) == 14
    for name in launching:
        vs = records[name]["plain"]
        assert vs is not None and vs["ok"], (name, vs)
        assert vs["max_abs_err"] == 0.0 and vs["ids_differ"] == 0, name
    assert records["build.scatter_append_in_place"]["plain"] is None


def test_segment_sum_drops_out_of_range_ids_without_a_sync():
    """``linalg.segment_sum`` drops ids outside [0, n) into a discard slot
    (the JAX scatter semantics) and reads nothing back to the host."""
    import jax.numpy as jnp
    import jax.ops
    import numpy as np

    from raft_tpu_torch.linalg import segment_sum

    rng = np.random.default_rng(0)
    data = rng.standard_normal((64, 3)).astype(np.float32)
    ids = rng.integers(-3, 11, 64).astype(np.int32)
    want = np.array(jax.ops.segment_sum(jnp.asarray(data),
                                        jnp.asarray(ids), 8))
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 8)
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-6,
                               atol=1e-6)
    entry = registry.ProgramEntry("seeded.segment_sum", lambda d: dict(
        fn=segment_sum, args=(torch.from_numpy(data),
                              torch.from_numpy(ids), 8)))
    assert program_audit.measure(entry, CPU)["host_reads"] == 0


def test_cpu_goldens_committed_and_clean(records):
    scope = program_audit.scope(CPU)
    fps = {n: fingerprint.of(r) for n, r in records.items()}
    out = io.StringIO()
    reports, failed = fingerprint.compare(fps, sorted(fps), out=out)
    assert failed == 0, out.getvalue()
    assert {r.status for r in reports} == {"ok"}
    assert fingerprint.stale_goldens(scope, sorted(fps)) == []
    for name in fps:
        path = fingerprint.GOLDEN_DIR / scope / f"{name}.json"
        assert path.read_text() == fingerprint.dumps(
            json.loads(path.read_text()))


def test_golden_round_trip(records, tmp_path):
    fps = {n: fingerprint.of(r) for n, r in records.items()}
    _, failed = fingerprint.compare(fps, sorted(fps), golden_dir=tmp_path,
                                    update=True, out=io.StringIO())
    assert failed == 0
    reports, failed = fingerprint.compare(fps, sorted(fps),
                                          golden_dir=tmp_path,
                                          out=io.StringIO())
    assert failed == 0 and {r.status for r in reports} == {"ok"}
    # deterministic: rewriting gives the same bytes
    before = {p: p.read_bytes() for p in tmp_path.rglob("*.json")}
    fingerprint.compare(fps, sorted(fps), golden_dir=tmp_path, update=True,
                        out=io.StringIO())
    assert before == {p: p.read_bytes() for p in tmp_path.rglob("*.json")}


def test_golden_of_another_scope_is_skipped(records, tmp_path):
    name = "kernels.select_k"
    fp = fingerprint.of(records[name])
    other = dict(fp, scope="NVIDIA_H100_80GB_HBM3-sm_90-torch2.11")
    d = tmp_path / other["scope"]
    d.mkdir()
    (d / f"{name}.json").write_text(fingerprint.dumps(other))
    reports, failed = fingerprint.compare({name: fp}, [name],
                                          golden_dir=tmp_path,
                                          out=io.StringIO())
    assert failed == 0 and reports[0].status == "skipped"


class TestSeededRegressions:
    """Each seeded drift fails the diff or the budget; jitter passes."""

    @pytest.fixture
    def golden(self, records):
        return fingerprint.of(records["ann_mnmg.ivf_flat_sharded"])

    def test_extra_collective_fails(self, golden):
        cur = copy.deepcopy(golden)
        cur["collectives"] += 1
        cur["collective_bytes"] *= 2
        f = fingerprint.diff(golden, cur)
        assert any("collectives" in x for x in f)
        assert any("collective_bytes" in x for x in f)
        e = registry.get_program("ann_mnmg.ivf_flat_sharded")
        rec = dict(cur, host_reads=0, in_place=[], in_place_expected=[])
        assert program_audit.check(e, rec)

    def test_float64_upcast_fails(self):
        entry = registry.ProgramEntry(
            "seeded.upcast", lambda d: dict(
                fn=lambda x: (x @ x.T).sum(1),
                args=(torch.ones((8, 4), device=d),)))
        clean = fingerprint.of(program_audit.measure(entry, CPU))
        up = registry.ProgramEntry(
            "seeded.upcast", lambda d: dict(
                fn=lambda x: (x.double() @ x.double().T).sum(1).float(),
                args=(torch.ones((8, 4), device=d),)))
        drifted = fingerprint.of(program_audit.measure(up, CPU))
        f = fingerprint.diff(clean, drifted)
        assert any("gained ['float64']" in x for x in f), f

    def test_lost_in_place_write_fails(self):
        def build(d, copy_it):
            blk = torch.zeros((16, 4), device=d)

            def write(b, rows, v):
                out = b.clone() if copy_it else b
                out[rows] = v
                return out
            return dict(fn=write, args=(blk, torch.arange(4),
                                        torch.ones(4, 4)))

        good = registry.ProgramEntry("seeded.inplace",
                                     lambda d: build(d, False),
                                     in_place=(0,))
        lost = registry.ProgramEntry("seeded.inplace",
                                     lambda d: build(d, True),
                                     in_place=(0,))
        rg = program_audit.measure(good, CPU)
        rl = program_audit.measure(lost, CPU)
        assert program_audit.check(good, rg) == []
        assert any("in-place" in x for x in program_audit.check(lost, rl))
        assert fingerprint.diff(fingerprint.of(rg), fingerprint.of(rl))

    def test_op_jitter_within_tolerance_passes(self, golden):
        cur = copy.deepcopy(golden)
        op = max(cur["ops"], key=cur["ops"].get)
        cur["ops"][op] += 1
        assert fingerprint.diff(golden, cur) == []
        cur["ops"][op] = golden["ops"][op] * 2 + 3
        assert fingerprint.diff(golden, cur)

    def test_launch_drift_fails(self, golden):
        cur = copy.deepcopy(golden)
        cur["launches"] = {"select_k": 1}
        assert fingerprint.diff(golden, cur)

    def test_schema_mismatch_asks_for_update(self, golden):
        cur = dict(golden, schema=golden["schema"] + 1)
        assert "update-goldens" in fingerprint.diff(golden, cur)[0]


class TestAgainstPlain:
    """A kernel whose outputs leave its plain version's fails the audit;
    a swap of near ties does not."""

    @staticmethod
    def _check(out, ref):
        entry = registry.ProgramEntry("seeded.plain", lambda d: dict(
            fn=lambda: out, args=(), plain=lambda: ref))
        return program_audit.check(entry, program_audit.measure(entry, CPU))

    def test_agreeing_outputs_pass(self):
        d = torch.arange(400.0).reshape(100, 4)
        i = torch.arange(400, dtype=torch.int32).reshape(100, 4)
        i2 = i.clone()
        i2[0, :2] = i2[0, :2].flip(0)          # one swapped pair
        assert self._check((d + 1e-3, i2), (d, i)) == []

    def test_wrong_values_fail(self):
        d = torch.arange(400.0).reshape(100, 4)
        f = self._check((d + 1.0, None), (d, None))
        assert any("plain version" in x for x in f), f

    def test_wrong_ids_fail(self):
        i = torch.arange(400, dtype=torch.int32)
        assert self._check((i + 1,), (i,))

    def test_non_finite_slots_and_shapes_must_match(self):
        d = torch.ones(8)
        inf = d.clone()
        inf[3] = float("inf")
        assert self._check((inf,), (d,))
        assert self._check((d[:4],), (d,))


class TestHostSyncCounting:
    """The CPU counts the points that wait on the card."""

    @staticmethod
    def _reads(fn, *args):
        entry = registry.ProgramEntry("seeded.syncs",
                                      lambda d: dict(fn=fn, args=args))
        return program_audit.measure(entry, CPU)["host_reads"]

    def test_item_and_bool(self):
        assert self._reads(lambda x: x.sum().item(), torch.ones(4)) == 1
        assert self._reads(lambda x: bool((x > 0).all()), torch.ones(4)) == 1

    def test_read_to_host_counted_once(self):
        assert self._reads(lambda x: x.cpu().numpy(), torch.ones(4)) == 1
        assert self._reads(lambda x: x.tolist(), torch.ones(4)) == 1

    def test_data_sized_ops(self):
        assert self._reads(lambda x: x[x > 0], torch.ones(4)) == 1
        assert self._reads(lambda x: torch.nonzero(x), torch.ones(4)) == 1
        assert self._reads(lambda x: x * 2, torch.ones(4)) == 0


def test_cli_audit_and_fingerprints_exit_zero():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "raft_tpu_torch.analysis",
                          "--audit", "--fast"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "program_audit: 13 program(s) verified, 0 failed" in out.stdout
