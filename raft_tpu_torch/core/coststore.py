"""On-disk store of the serving cost rows (port of the cost half of
``raft_tpu/core/aotstore.py``: ``save_costs`` / ``load_costs`` :132-183,
``install`` / ``installed``).

``ServeEngine.close()`` persists its scheduler cost model's observed
per-(dtype, bucket) service times here, and the next engine over the same
backend program seeds its model from them at construction, so its first
scheduler decisions use real costs instead of the static fallback.

The JAX store also keeps compiled executables.  The port has none to
keep: its kernels are ``nvcc``-built libraries cached by a hash of their
source (``kernels/native.py``), and PyTorch runs eagerly.  So this store
holds cost rows only.

A manifest is one JSON file per backend program, named by a digest of its
scope: the store's schema, ``torch.__version__``, the device's name and
compute capability, and the program's label.  A row measured on another
card or under another PyTorch is never read back.  Writes are atomic and
merge over the manifest already there.  A miss or an unreadable manifest
reads as no rows (and warns once): costs are an accelerator, never a
correctness dependency.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from typing import Dict, Optional, Tuple

import torch

#: manifest format version — bump on any layout change; a manifest of
#: another version is a miss
SCHEMA = 1


def device_scope(device=None) -> str:
    """The device part of the scope: name and compute capability of
    *device* (default: the current card, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"{torch.cuda.get_device_name(device)}|sm_{major}{minor}"


class CostStore:
    """Directory-backed store of per-program cost manifests."""

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self._warned = False

    def _file(self, fn: str, device) -> str:
        scope = f"{SCHEMA}|{torch.__version__}|{device_scope(device)}|{fn}"
        digest = hashlib.sha256(scope.encode()).hexdigest()
        return os.path.join(self.path, f"{digest[:32]}.costs.json")

    def save_costs(self, fn: str, rows: Dict[Tuple[str, int], float],
                   device=None) -> bool:
        """Persist one backend program's observed per-(dtype, bucket)
        service-time rows (atomic write, merged over the manifest already
        there; rows that are not positive are dropped).  False when there
        was nothing to write or the write failed."""
        merged = {f"{dt}|{int(b)}": float(v)
                  for (dt, b), v in rows.items() if float(v) > 0.0}
        if not merged:
            return False
        for (dt, b), v in self.load_costs(fn, device).items():
            merged.setdefault(f"{dt}|{int(b)}", v)
        path = self._file(fn, device)
        try:
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": SCHEMA, "fn": fn, "rows": merged}, f)
            os.replace(tmp, path)   # atomic: no torn manifests
            return True
        except OSError as e:
            self._warn(f"cost-manifest write failed for {fn} ({e!r})")
            return False

    def load_costs(self, fn: str, device=None
                   ) -> Dict[Tuple[str, int], float]:
        """The persisted per-(dtype, bucket) rows of one backend program;
        empty on a miss or an unreadable manifest."""
        try:
            with open(self._file(fn, device)) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as e:
            self._warn(f"unreadable cost manifest for {fn} ({e!r})")
            return {}
        out: Dict[Tuple[str, int], float] = {}
        try:
            if payload["schema"] != SCHEMA:
                return {}
            for key, v in payload["rows"].items():
                dt, _, b = key.rpartition("|")
                out[(dt, int(b))] = float(v)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            self._warn(f"malformed cost manifest for {fn} ({e!r})")
            return {}
        return out

    def _warn(self, msg: str) -> None:
        if not self._warned:
            self._warned = True
            warnings.warn(f"coststore: {msg} — serving starts from the "
                          "static cost estimate (further store warnings "
                          "suppressed)", RuntimeWarning, stacklevel=3)


_installed: Optional[CostStore] = None


def install(path_or_store) -> Optional[CostStore]:
    """Install a store process-wide (a path or a :class:`CostStore`);
    returns the PREVIOUS one so callers can restore it.  ``None``
    uninstalls."""
    global _installed
    store = (path_or_store if path_or_store is None
             or isinstance(path_or_store, CostStore)
             else CostStore(path_or_store))
    prev, _installed = _installed, store
    return prev


def installed() -> Optional[CostStore]:
    return _installed
