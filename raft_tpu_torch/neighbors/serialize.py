"""Index archives, in the JAX package's format both ways (port of
``raft_tpu/neighbors/serialize.py``: ``_finish`` :67, ``_atomic_savez``
:89, ``_unpack`` :108, ``save_ivf_flat`` :144, ``load_ivf_flat`` :152,
``save_ivf_pq`` :160, ``save_sharded`` :170, ``load_sharded`` :200,
``_peek_kind`` :224, ``save_mutable`` :265, ``load_mutable`` :337,
``save_tiered`` :417, ``load_tiered`` :445, ``load_ivf_pq`` :471), with
numpy only.  A sharded
archive holds the replicated tables and every rank's blocks stacked as
(world, …); the port's ``save_sharded`` gathers them to the first rank,
which writes, and ``load_sharded`` gives each rank its own row.  A
mutable archive of a sharded main stores the main the same way
(``main_rep{j}`` / ``main_st{j}``) beside the books, and
``load_sharded`` / ``load_mutable`` restore it onto a communicator of
the archived world.

An archive is one ``.npz``: every array leaf plus ``__header__``, a JSON
header (magic, per-kind version, kind, aux, per-array CRC32 manifest).
A save writes a temporary file beside the destination, fsyncs it and
renames it into place, so a reader sees the old archive or the new one,
never a part.  Damage (zip errors, a mangled header, a checksum mismatch)
raises :class:`~raft_tpu_torch.core.error.CorruptionError`.  IVF-PQ
version 2 archives carry the list-side ADC tables and are read as
stored; version 1 archives predate them, and ``list_adc`` / ``list_csum``
are recomputed from the trained model and the stored codes.  A bfloat16
array is stored as its bits in two-byte raw items (``|V2``, what the JAX
package's ``np.savez`` writes), and its checksum is taken over those
bytes.  The JAX package cannot read its own bfloat16 archives back
(``jnp.asarray`` refuses ``|V2``); the port reads both.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from raft_tpu_torch.core.error import CorruptionError, LogicError, expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors._common import array_to_tensor, tensor_to_array

_MAGIC = "raft-tpu-index"
#: the version each kind is written at (the JAX package's)
_VERSIONS = {"ivf_flat": 1, "ivf_pq": 2, "mutable": 1, "tiered": 1,
             "sharded": 1}
_READABLE_VERSIONS = {"ivf_flat": (1,), "ivf_pq": (1, 2), "mutable": (1,),
                      "sharded": (1,),
                      "tiered": (1,)}


def _normalize(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _checksums(arrays: dict) -> dict:
    return {name: int(zlib.crc32(np.ascontiguousarray(a).tobytes())
                      & 0xFFFFFFFF)
            for name, a in arrays.items()}


def _finish(kind: str, arrays: dict, aux: dict) -> dict:
    """Attach the JSON header (version, aux, checksum manifest)."""
    header = {"magic": _MAGIC, "version": _VERSIONS[kind], "kind": kind,
              "aux": aux, "checksums": _checksums(arrays)}
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    return arrays


def _atomic_savez(path, arrays: dict) -> None:
    """Temporary file beside the destination, fsync, atomic rename; a
    failed save leaves nothing behind."""
    path = _normalize(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _flat_aux(index: ivf_flat.Index) -> dict:
    return {"metric": int(index.metric),
            "adaptive_centers": bool(index.adaptive_centers)}


def _pq_aux(index: ivf_pq.Index) -> dict:
    return {"metric": int(index.metric),
            "codebook_kind": int(index.codebook_kind),
            "pq_bits": int(index.pq_bits),
            "dataset_dtype": index.dataset_dtype}


def _leaves(index) -> dict:
    fields = (ivf_flat.ARRAY_FIELDS if isinstance(index, ivf_flat.Index)
              else ivf_pq.ARRAY_FIELDS)
    return {name: tensor_to_array(getattr(index, name)) for name in fields}


def _unpack(path, kind: str):
    """(aux, arrays) of an archive of *kind*, header and checksums
    verified."""
    path = _normalize(path)
    try:
        with np.load(path) as z:
            expects("__header__" in z.files,
                    f"{path}: not a raft-tpu index file (no header)")
            header = json.loads(bytes(z["__header__"]).decode())
            expects(header.get("magic") == _MAGIC,
                    f"{path}: not a raft-tpu index file")
            if header["kind"] != kind:
                raise LogicError(
                    f"{path} holds a {header['kind']} index, not {kind}")
            expects(header.get("version") in _READABLE_VERSIONS[kind],
                    f"{path}: unsupported {kind} index version "
                    f"{header.get('version')}")
            arrays = {k: z[k] for k in z.files if k != "__header__"}
    except (zipfile.BadZipFile, zlib.error, EOFError, ValueError,
            json.JSONDecodeError, UnicodeDecodeError, KeyError, OSError) as e:
        raise CorruptionError(
            f"{path}: corrupt or truncated index archive ({e})") from e
    manifest = header.get("checksums")
    if manifest is not None:
        stored = _checksums(arrays)
        bad = sorted(name for name, crc in stored.items()
                     if manifest.get(name) != crc)
        missing = sorted(set(manifest) - set(stored))
        if bad or missing:
            raise CorruptionError(
                f"{path}: checksum manifest mismatch "
                f"(corrupt: {bad or '-'}, missing: {missing or '-'}) — "
                "the archive is damaged; rebuild or restore it")
    return header["aux"], arrays


def save_ivf_flat(path, index: ivf_flat.Index) -> None:
    """Write an IVF-Flat index to *path* (``.npz``; atomic and
    checksummed) — the JAX package's ``load_ivf_flat`` reads it."""
    _atomic_savez(path, _finish("ivf_flat", _leaves(index),
                                _flat_aux(index)))


def load_ivf_flat(path, device=None) -> ivf_flat.Index:
    """An :class:`ivf_flat.Index` on *device* (``None``: the card) from an
    archive either package's ``save_ivf_flat`` wrote."""
    dev = resolve_device(device)
    aux, a = _unpack(path, "ivf_flat")
    return ivf_flat.index_from_arrays(a, aux["metric"],
                                      aux["adaptive_centers"], device=dev)


def save_ivf_pq(path, index: ivf_pq.Index) -> None:
    """Write an IVF-PQ index to *path* (``.npz``, version 2; atomic and
    checksummed) — the JAX package's ``load_ivf_pq`` reads it."""
    _atomic_savez(path, _finish("ivf_pq", _leaves(index), _pq_aux(index)))


def _gather_leaf(comms, leaf: torch.Tensor) -> np.ndarray:
    """Every rank's block of one stacked leaf as the (world, …) array of
    the archive (bfloat16 travels as its bits)."""
    bf16 = leaf.dtype == torch.bfloat16
    parts = comms.allgather(leaf.view(torch.int16) if bf16 else leaf)
    return tensor_to_array(parts.view(torch.bfloat16) if bf16 else parts)


def _sharded_arrays(sharded, prefix: str = ""):
    """The archive arrays of a ``ShardedIndex`` (``rep{j}``, ``st{j}``
    after *prefix*) on the communicator's first rank, None on the others
    — a collective: the stacked blocks are gathered to the first rank."""
    comms = sharded.comms
    stacked = [_gather_leaf(comms, leaf) for leaf in sharded.stacked]
    if comms.get_rank() != 0:
        return None
    arrays = {f"{prefix}rep{j}": tensor_to_array(leaf)
              for j, leaf in enumerate(sharded.replicated)}
    arrays.update({f"{prefix}st{j}": a for j, a in enumerate(stacked)})
    return arrays


def _sharded_from_arrays(kind: str, sh_aux: dict, a: dict, comms, dev,
                         prefix: str = ""):
    """This rank's ``ShardedIndex`` of an archive's arrays: the replicated
    tables and this rank's row of each stacked leaf.  The archive's world
    must be the communicator's size — a partition is laid out for one
    world; re-shard the base index to change it."""
    from raft_tpu_torch.comms.comms import as_comms
    from raft_tpu_torch.neighbors import ann_mnmg

    comms = ann_mnmg._full_axis_comms(as_comms(comms))
    world = int(sh_aux["world"])
    expects(world == comms.get_size(),
            f"archive was sharded for world={world}, communicator has "
            f"{comms.get_size()} — re-shard the base index instead")
    rank = comms.get_rank()
    n_rep = sum(1 for name in a if name.startswith(f"{prefix}rep"))
    n_st = sum(1 for name in a if name.startswith(f"{prefix}st"))
    replicated = tuple(array_to_tensor(a[f"{prefix}rep{j}"], dev)
                       for j in range(n_rep))
    stacked = tuple(array_to_tensor(a[f"{prefix}st{j}"][rank], dev)
                    for j in range(n_st))
    return ann_mnmg.ShardedIndex(kind, comms, replicated, stacked,
                                 dict(sh_aux))


def save_sharded(path, sharded) -> None:
    """Write an ``ann_mnmg.ShardedIndex`` to *path* (``.npz``; atomic and
    checksummed) in the JAX package's layout: ``rep{j}`` the replicated
    tables, ``st{j}`` each stacked leaf as (world, …), the aux (world
    included) in the header.  A collective: every rank calls it, the
    blocks are gathered to the first rank, which writes, and every rank
    returns once the archive is in place.  A ``MutableIndex`` (over a
    sharded main or not) goes to :func:`save_mutable`, as in the JAX
    package."""
    from raft_tpu_torch.neighbors import mutable as _mutable

    if isinstance(sharded, _mutable.MutableIndex):
        return save_mutable(path, sharded)
    arrays = _sharded_arrays(sharded)
    if arrays is not None:
        _atomic_savez(path, _finish("sharded", arrays,
                                    {"kind": sharded.kind,
                                     "aux": dict(sharded.aux)}))
    sharded.comms.barrier()


def load_sharded(path, comms, device=None):
    """An ``ann_mnmg.ShardedIndex`` from an archive either package's
    ``save_sharded`` wrote: every rank reads the replicated tables and its
    own row of each stacked leaf onto *device* (``None``: the card).  A
    mutable archive goes to :func:`load_mutable`, as in the JAX package
    (*comms* is then needed only when its main is sharded)."""
    if _peek_kind(path) == "mutable":
        return load_mutable(path, device, comms)
    aux, a = _unpack(path, "sharded")
    return _sharded_from_arrays(aux["kind"], aux["aux"], a, comms,
                                resolve_device(device))


def _peek_kind(path) -> str:
    """The kind in an archive's header, read without its arrays."""
    path = _normalize(path)
    try:
        with np.load(path) as z:
            expects("__header__" in z.files,
                    f"{path}: not a raft-tpu index file (no header)")
            header = json.loads(bytes(z["__header__"]).decode())
    except (zipfile.BadZipFile, zlib.error, EOFError, ValueError,
            json.JSONDecodeError, UnicodeDecodeError, KeyError, OSError) as e:
        raise CorruptionError(
            f"{path}: corrupt or truncated index archive ({e})") from e
    return header.get("kind", "")


def load_ivf_pq(path, device=None) -> ivf_pq.Index:
    """An :class:`ivf_pq.Index` on *device* (``None``: the card) from an
    archive either package's ``save_ivf_pq`` wrote."""
    dev = resolve_device(device)
    aux, a = _unpack(path, "ivf_pq")
    if "list_adc" not in a or "list_csum" not in a:
        # version 1: the list-side tables are pure functions of the model
        # and the stored codes
        t = {k: torch.as_tensor(a[k], device=dev)
             for k in ("centers", "rotation", "codebooks", "list_codes",
                       "owner")}
        per_cluster = (ivf_pq.CodebookKind(aux["codebook_kind"])
                       == ivf_pq.CodebookKind.PER_CLUSTER)
        rot_centers = t["centers"] @ t["rotation"]
        a.setdefault("list_adc", ivf_pq._build_list_adc(
            rot_centers, t["codebooks"], per_cluster).cpu().numpy())
        a.setdefault("list_csum", ivf_pq._csum_for_packed(
            t["list_codes"], t["owner"], rot_centers, t["codebooks"],
            int(aux["pq_bits"]), per_cluster=per_cluster).cpu().numpy())
    return ivf_pq.index_from_arrays(
        a, aux["metric"], aux["codebook_kind"], aux["pq_bits"],
        aux.get("dataset_dtype", "float32"), device=dev)


def _params_to_aux(params):
    """Family IndexParams → a JSON-safe dict (enums → ints)."""
    if params is None:
        return None
    return {k: (int(v) if isinstance(v, enum.IntEnum) else v)
            for k, v in dataclasses.asdict(params).items()}


def _params_from_aux(kind: str, d):
    if d is None:
        return None
    d = dict(d)
    d["metric"] = DistanceType(d["metric"])
    if kind == "ivf_pq":
        d["codebook_kind"] = ivf_pq.CodebookKind(d["codebook_kind"])
        return ivf_pq.IndexParams(**d)
    return ivf_flat.IndexParams(**d)


def save_mutable(path, mut) -> None:
    """Write a :class:`~raft_tpu_torch.neighbors.mutable.MutableIndex` to
    *path* (``.npz``; atomic and checksummed): one snapshot of the (main,
    delta, tombstones) triple taken under the write lock.  The main is
    stored as it is (a sharded main as ``main_rep{j}`` / ``main_st{j}``,
    the :func:`save_sharded` layout); the delta and the tombstones as
    their host books (live delta rows with their ids in insertion order,
    the dead main ids, the live main rows), which :func:`load_mutable`
    replays through ``upsert`` / ``delete`` — the JAX package's layout,
    so either package reads the other's.  Over a sharded main a
    collective: every rank calls it, the first rank writes, every rank
    returns once the archive is in place."""
    from raft_tpu_torch.neighbors import mutable as _mutable

    expects(isinstance(mut, _mutable.MutableIndex),
            "save_mutable needs a MutableIndex")
    with mut._lock:
        core = mut._mut_core
        index = core.main
        if mut.sharded:
            arrays = _sharded_arrays(index, "main_")
            fam = {"aux": dict(index.aux)}
        else:
            arrays = {f"main_{name}": a
                      for name, a in _leaves(index).items()}
            fam = (_flat_aux(index) if core.kind == "ivf_flat"
                   else _pq_aux(index))
        if arrays is not None:
            arrays.update(_mutable_books(core))
            aux = {"kind": core.kind, "sharded": mut.sharded,
                   "family": fam,
                   "build_params": _params_to_aux(mut.build_params)}
            _atomic_savez(path, _finish("mutable", arrays, aux))
    if mut.sharded:
        mut.comms.barrier()


def _mutable_books(core) -> dict:
    """A mutable core's host books as archive arrays."""
    arrays = {"mut_main_ids": core.main_ids.astype(np.int64),
              "mut_main_dead": np.asarray(sorted(core.main_dead), np.int64)}
    live = core.main_live_mask()
    arrays["mut_main_live_ids"] = core.main_ids[live].astype(np.int64)
    if live.any():
        # main_x holds the rows in the order they came (only the live
        # ones after a load): each id's row is main_row's
        rows = torch.as_tensor(core.main_row[live], device=core.main_x.device)
        arrays["mut_main_live_rows"] = tensor_to_array(core.main_x[rows])
    delta_ids = np.asarray(list(core.delta_live), np.int64)
    arrays["mut_delta_ids"] = delta_ids
    if delta_ids.size:
        arrays["mut_delta_rows"] = tensor_to_array(torch.stack(
            [core.delta_x[int(j)] for j in delta_ids]))
    return arrays


def load_mutable(path, device=None, comms=None):
    """A :class:`~raft_tpu_torch.neighbors.mutable.MutableIndex` on
    *device* (``None``: the card) from an archive either package's
    ``save_mutable`` wrote: the main restored as stored, then the archived
    delta rows upserted and the dead main ids deleted — the same live rows
    through the same programs.  An archive of a sharded main is restored
    onto *comms*, a communicator of the archived world (every rank calls
    it, and gets its own shard and the same books)."""
    from raft_tpu_torch.neighbors import mutable as _mutable

    dev = resolve_device(device)
    aux, a = _unpack(path, "mutable")
    fam_kind, fam = aux["kind"], aux["family"]
    if aux["sharded"]:
        expects(comms is not None,
                "load_mutable: the archive holds a sharded main — pass comms")
        main = _sharded_from_arrays(fam_kind, fam["aux"], a, comms, dev,
                                    "main_")
    else:
        expects(comms is None, "load_mutable: the archive holds a "
                "single-device main — comms= goes with a sharded one")
        arrays = {k[len("main_"):]: v for k, v in a.items()
                  if k.startswith("main_")}
        if fam_kind == "ivf_flat":
            main = ivf_flat.index_from_arrays(arrays, fam["metric"],
                                              fam["adaptive_centers"],
                                              device=dev)
        else:
            main = ivf_pq.index_from_arrays(
                arrays, fam["metric"], fam["codebook_kind"], fam["pq_bits"],
                fam.get("dataset_dtype", "float32"), device=dev)
    main_ids = a["mut_main_ids"].astype(np.int64)
    delta_ids = a["mut_delta_ids"].astype(np.int64)
    live_main = a["mut_main_live_ids"].astype(np.int64)
    rows = a.get("mut_main_live_rows")
    live_rows = (array_to_tensor(rows, dev) if rows is not None
                 else torch.zeros((0, main.dim), device=dev))
    mut = _mutable.MutableIndex(
        main, live_rows, live_main,
        build_params=_params_from_aux(fam_kind, aux["build_params"]))
    mut._restore_roster(main_ids, int(delta_ids.max()) if delta_ids.size
                        else 0)
    if delta_ids.size:
        mut.upsert(array_to_tensor(a["mut_delta_rows"], dev), delta_ids)
    dead = np.setdiff1d(a["mut_main_dead"].astype(np.int64), delta_ids)
    if dead.size:
        mut.delete(dead)
    return mut


def save_tiered(path, tiered) -> None:
    """Write a :class:`~raft_tpu_torch.neighbors.tiering.TieredIndex` to
    *path* (``.npz``; atomic and checksummed): the resident family
    leaves, reassembled from the host blocks, plus the residency policy
    (the hot-list mask, the tile size) and the host refine store.  The
    split itself is not stored: :func:`load_tiered` recuts it from the
    mask.  The JAX package's layout, so either package reads the
    other's."""
    from raft_tpu_torch.neighbors import tiering

    if tiered.kind == "ivf_flat":
        fam = {"metric": int(tiered.metric),
               "adaptive_centers": bool(tiered.aux["adaptive_centers"])}
    else:
        fam = {"metric": int(tiered.metric),
               "codebook_kind": int(tiered.aux["codebook_kind"]),
               "pq_bits": int(tiered.aux["pq_bits"]),
               "dataset_dtype": tiered.aux["dataset_dtype"]}
    arrays = {name: tensor_to_array(t)
              for name, t in tiering.family_arrays(tiered).items()}
    arrays["tiered_hot_lists"] = np.asarray(tiered.hot_lists)
    if tiered.refine_store is not None:
        arrays["tiered_refine_store"] = tiered.refine_store.cpu().numpy()
    aux = {"kind": tiered.kind, "tile_phys": int(tiered.tile_phys),
           "family": fam}
    _atomic_savez(path, _finish("tiered", arrays, aux))


def load_tiered(path, device=None):
    """A tiered index on *device* (``None``: the card) from an archive
    either package's ``save_tiered`` wrote: the family index restored on
    the host, then tiered onto *device* under the archived hot-list mask
    and tile size — the same split as the saved one, with only the model
    tables and the hot block put on the device."""
    from raft_tpu_torch.neighbors import tiering

    dev = resolve_device(device)
    aux, a = _unpack(path, "tiered")
    mask = a.pop("tiered_hot_lists").astype(bool)
    store = a.pop("tiered_refine_store", None)
    fam = aux["family"]
    if aux["kind"] == "ivf_flat":
        index = ivf_flat.index_from_arrays(a, fam["metric"],
                                           fam["adaptive_centers"],
                                           device="cpu")
    else:
        index = ivf_pq.index_from_arrays(
            a, fam["metric"], fam["codebook_kind"], fam["pq_bits"],
            fam.get("dataset_dtype", "float32"), device="cpu")
    return tiering.tier(index, hot_lists=mask,
                        tile_phys=int(aux["tile_phys"]), dataset=store,
                        device=dev)
