"""The YCSB op stream of one replay: a frozen copy of the generator the
program ships (``repro_torch.storage.ycsb.generate`` and
``repro_torch.engine.stream.attach_clients``), kept here so that no change
to the program moves the benchmark's inputs.

Keys follow YCSB's zipfian request distribution over the key space
(``requestdistribution=zipfian``, θ = 0.99 by default), reads and writes
are drawn independently at the mix's read fraction, and each op carries
the client that issued it and the replica that serves it: a client's home
replica is its DC (``client % n_replicas``), and 30 % of its ops hit one
of the next two replicas in ring order (client mobility).
"""

from __future__ import annotations

import numpy as np

READ, WRITE = 0, 1


def op_stream(*, n_ops: int, n_keys: int, n_clients: int, read_fraction: float,
              zipf_theta: float, seed: int, n_replicas: int = 3) -> dict[str, np.ndarray]:
    """``client``, ``kind`` (0 = read, 1 = write), ``resource`` and ``home``
    of ``n_ops`` ops, int32 each, from ``seed`` (any whole number)."""
    seed = int(seed) % (2 ** 63)
    rng = np.random.default_rng(seed)
    kind = (rng.random(n_ops) >= read_fraction).astype(np.int32)
    # Zipfian over a permuted key space (standard YCSB scrambling).
    ranks = rng.zipf(1.0 + zipf_theta, size=n_ops)
    key = ((ranks - 1) % n_keys).astype(np.int64)
    rng = np.random.default_rng(seed + 1)
    client = rng.integers(0, n_clients, n_ops).astype(np.int32)
    move = rng.random(n_ops) < 0.30
    offset = rng.integers(1, 3, n_ops)
    home = ((client % n_replicas + np.where(move, offset, 0)) % n_replicas).astype(np.int32)
    return {"client": client, "kind": kind, "resource": (key % n_keys).astype(np.int32),
            "home": home}
