"""Replicated checkpoint store with consistency levels (port of
``repro.checkpoint.store``).

A :class:`CheckpointStore` spans N replica directories (stand-ins for
per-datacenter blob stores).  Writes are acknowledged per the
consistency level (ONE/QUORUM/ALL) and propagate to the remaining
replicas after a configurable lag (the Tp of the staleness model);
causal-family levels stamp each write with the writer's session version
and readers are session-guarded (a restarting worker can never observe
an older checkpoint than one it has already seen — monotonic read — nor
miss its own last save — read-your-write).

The on-disk layout is the reference's: ``replica_r/META.json`` and
``ckpt_v{n}.npz`` holding one array per leaf, keys joined with ``/`` in
the reference's leaf order, so an f32 checkpoint written by either
package restores in the other.  numpy has no bfloat16, so a bf16 leaf is
stored as its uint16 bit pattern and the npz's ``__dtypes__`` entry (a
JSON map from key to dtype name, written only when a leaf needs it)
records the dtype; such a leaf restores bit for bit in the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.device import resolve_device
from repro_torch.tree import items, tree_map

DTYPES_KEY = "__dtypes__"
# Leaves numpy cannot hold, stored as their bit pattern.
_BITS = {torch.bfloat16: (torch.int16, np.uint16)}


def _flatten(params) -> dict[str, np.ndarray]:
    flat, dtypes = {}, {}
    for key, leaf in items(params):
        t = leaf.detach().cpu()
        if t.dtype in _BITS:
            view, np_bits = _BITS[t.dtype]
            dtypes[key] = str(t.dtype).removeprefix("torch.")
            flat[key] = t.view(view).numpy().view(np_bits)
        else:
            flat[key] = t.numpy()
    if dtypes:
        flat[DTYPES_KEY] = np.array(json.dumps(dtypes))
    return flat


def _leaf(arr: np.ndarray, dtype_name: str | None, like, device) -> torch.Tensor:
    if dtype_name is not None:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(getattr(torch, dtype_name))
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=like.dtype)


def _unflatten(template, flat: dict[str, np.ndarray], device: torch.device):
    dtypes = json.loads(str(flat[DTYPES_KEY])) if DTYPES_KEY in flat else {}
    it = iter([_leaf(flat[k], dtypes.get(k), leaf, device) for k, leaf in items(template)])
    return tree_map(lambda _: next(it), template)


@dataclasses.dataclass
class SessionToken:
    """Client-side session floors (MR + RYW) for checkpoint readers."""

    client_id: int
    read_floor: int = 0   # highest version observed
    write_floor: int = 0  # highest version written


class CheckpointStore:
    """``device`` is where :meth:`restore` puts the parameters (``"cuda"``
    by default; without a card it raises unless given ``"cpu"``)."""

    def __init__(
        self,
        root: str,
        n_replicas: int = 3,
        level: ConsistencyLevel = ConsistencyLevel.X_STCC,
        propagation_lag_s: float = 0.0,
        device="cuda",
    ):
        self.root = root
        self.n_replicas = n_replicas
        self.level = level
        self.propagation_lag_s = propagation_lag_s
        self.device = resolve_device(device)
        for r in range(n_replicas):
            os.makedirs(self._rdir(r), exist_ok=True)

    def _rdir(self, r: int) -> str:
        return os.path.join(self.root, f"replica_{r}")

    def _meta_path(self, r: int) -> str:
        return os.path.join(self._rdir(r), "META.json")

    def _read_meta(self, r: int) -> dict:
        try:
            with open(self._meta_path(r)) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"version": 0, "entries": {}}

    def _write_meta(self, r: int, meta: dict) -> None:
        tmp = self._meta_path(r) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path(r))

    # -- write path -----------------------------------------------------------

    def save(self, params, step: int, session: SessionToken) -> int:
        """Write a checkpoint; ack per the level; propagate to the rest.

        Returns the committed version."""
        flat = _flatten(params)
        version = max(self._read_meta(r)["version"]
                      for r in range(self.n_replicas)) + 1
        acks = self.level.write_acks(self.n_replicas)
        entry = {
            "step": int(step),
            "version": version,
            "client": session.client_id,
            "time": time.time(),
        }
        payload_name = f"ckpt_v{version}.npz"
        order = list(range(self.n_replicas))
        # Coordinator = client's home replica first (local write, T≈0).
        home = session.client_id % self.n_replicas
        order.remove(home)
        order.insert(0, home)
        for i, r in enumerate(order):
            if i >= acks and self.propagation_lag_s > 0:
                # Lagged propagation: recorded as pending; `propagate()`
                # (or the next save) completes it.  Models Tp.
                meta = self._read_meta(r)
                meta.setdefault("pending", []).append(
                    dict(entry, payload=payload_name,
                         due=time.time() + self.propagation_lag_s)
                )
                self._write_meta(r, meta)
                continue
            np.savez(os.path.join(self._rdir(r), payload_name), **flat)
            meta = self._read_meta(r)
            meta["version"] = version
            meta["entries"][str(version)] = entry
            self._write_meta(r, meta)
        session.write_floor = max(session.write_floor, version)
        session.read_floor = max(session.read_floor, version)
        return version

    def propagate(self, now: float | None = None) -> int:
        """Complete due pending propagations.  Returns count applied."""
        now = time.time() if now is None else now
        done = 0
        for r in range(self.n_replicas):
            meta = self._read_meta(r)
            still = []
            for p in meta.get("pending", []):
                if p["due"] <= now:
                    src = None
                    for r2 in range(self.n_replicas):
                        cand = os.path.join(self._rdir(r2), p["payload"])
                        if os.path.exists(cand):
                            src = cand
                            break
                    if src:
                        dst = os.path.join(self._rdir(r), p["payload"])
                        if src != dst and not os.path.exists(dst):
                            shutil.copyfile(src, dst)
                        meta["version"] = max(meta["version"], p["version"])
                        meta["entries"][str(p["version"])] = {
                            k: p[k] for k in ("step", "version", "client", "time")
                        }
                        done += 1
                else:
                    still.append(p)
            meta["pending"] = still
            self._write_meta(r, meta)
        return done

    # -- read path -------------------------------------------------------------

    def latest_version(self, replica: int) -> int:
        return self._read_meta(replica)["version"]

    def restore(
        self,
        template,
        session: SessionToken,
        replica: int | None = None,
    ) -> tuple[Any, int, bool]:
        """Session-guarded restore onto the store's device.  ``template``
        gives the tree's keys and dtypes (meta tensors will do).

        Returns (params, version, rerouted).  Under X-STCC, a replica
        below the session floor is inadmissible — the read reroutes to an
        admissible replica (monotonic-read / read-your-write).  Weaker
        levels serve the raw replica (possibly stale)."""
        replica = session.client_id % self.n_replicas if replica is None else replica
        floor = max(session.read_floor, session.write_floor)
        v = self.latest_version(replica)
        rerouted = False
        if self.level.is_session_guarded and v < floor:
            # Reroute to the freshest admissible replica.
            best = max(range(self.n_replicas), key=self.latest_version)
            if self.latest_version(best) < floor:
                raise RuntimeError(
                    f"no replica satisfies session floor {floor}"
                )
            replica, rerouted = best, True
            v = self.latest_version(replica)
        if v == 0:
            raise FileNotFoundError("no checkpoint available")
        path = os.path.join(self._rdir(replica), f"ckpt_v{v}.npz")
        with np.load(path) as z:
            flat = dict(z)
        params = _unflatten(template, flat, self.device)
        session.read_floor = max(session.read_floor, v)
        return params, v, rerouted

    def stale_read_probe(self, session: SessionToken, replica: int) -> bool:
        """True if a raw read at `replica` would be stale (for metrics)."""
        global_latest = max(
            self.latest_version(r) for r in range(self.n_replicas)
        )
        return self.latest_version(replica) < global_latest
