"""Reading the JAX package's IVF-PQ index archives (port of
``raft_tpu/neighbors/serialize.py``: ``_unpack`` :108, ``load_ivf_pq``
:471), with numpy only.

An archive is one ``.npz``: every array leaf plus ``__header__``, a JSON
header (magic, per-kind version, kind, aux, per-array CRC32 manifest).
Damage (zip errors, a mangled header, a checksum mismatch) raises
:class:`~raft_tpu_torch.core.error.CorruptionError`.  Version 2 archives
carry the list-side ADC tables and are read as stored; version 1 archives
predate them, and ``list_adc`` / ``list_csum`` are recomputed from the
trained model and the stored codes.
"""

from __future__ import annotations

import json
import zipfile
import zlib

import numpy as np
import torch

from raft_tpu_torch.core.error import CorruptionError, LogicError, expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.neighbors import ivf_pq

_MAGIC = "raft-tpu-index"
_READABLE_VERSIONS = {"ivf_pq": (1, 2)}


def _normalize(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _checksums(arrays: dict) -> dict:
    return {name: int(zlib.crc32(np.ascontiguousarray(a).tobytes())
                      & 0xFFFFFFFF)
            for name, a in arrays.items()}


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


def load_ivf_pq(path, device=None) -> ivf_pq.Index:
    """An :class:`ivf_pq.Index` on *device* (``None``: the card) from an
    archive the JAX package's ``save_ivf_pq`` wrote."""
    dev = resolve_device(device)
    aux, a = _unpack(path, "ivf_pq")
    if "list_adc" not in a or "list_csum" not in a:
        # version 1: the list-side tables are pure functions of the model
        # and the stored codes
        t = {k: torch.as_tensor(a[k], device=dev)
             for k in ("centers", "rotation", "codebooks", "list_codes",
                       "owner")}
        expects(ivf_pq.CodebookKind(aux["codebook_kind"])
                == ivf_pq.CodebookKind.PER_SUBSPACE,
                "ivf_pq: codebook_kind=PER_CLUSTER is not ported yet")
        rot_centers = t["centers"] @ t["rotation"]
        a.setdefault("list_adc", ivf_pq._build_list_adc(
            rot_centers, t["codebooks"]).cpu().numpy())
        a.setdefault("list_csum", ivf_pq._csum_for_packed(
            t["list_codes"], t["owner"], rot_centers, t["codebooks"],
            int(aux["pq_bits"])).cpu().numpy())
    return ivf_pq.index_from_arrays(
        a, aux["metric"], aux["codebook_kind"], aux["pq_bits"],
        aux.get("dataset_dtype", "float32"), device=dev)
