"""The port's ``Trainer`` on the MoE and SSM families against the live JAX
reference's, on the CPU: reduced olmoe-1b-7b (the aux term in every
step's loss) and reduced rwkv6-3b under ``torch_port_helpers``'
``FAMILY_TRAIN_CASE`` (X_STCC, Δ = 2, int8 compression, 2 pods, 4 steps,
batch 4 x 16).  The port starts from the reference's initial parameters
and takes the reference's batches (its ``jax.random`` draws have no torch
counterpart, ROADMAP C).  Losses and grad norms within ``HISTORY_RTOL``
(``tests/test_torch_train.py``'s bound); the sync metrics, the final
clocks, the DUOT and the counters exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from torch_family_ref import reference_family_run
from torch_port_helpers import as_np, assert_tree_equal, family_trainer

torch.set_num_threads(1)
CPU = "cpu"
HISTORY_RTOL = 1e-5


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-3b"])
def test_trainer_matches_reference(arch):
    want = reference_family_run(arch)
    tr = family_trainer(arch, CPU)
    tr.batch_for = lambda s: {k: torch.from_numpy(v.copy())
                              for k, v in want["batches"][s].items()}
    state = tr.run(tr.init_state(params_from_numpy(want["params0"], device=CPU)))
    assert [h["step"] for h in tr.history] == [h["step"] for h in want["history"]]
    for g, w in zip(tr.history, want["history"]):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=HISTORY_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=HISTORY_RTOL)
        for k in ("synced", "inter_pod_gb", "violations", "severity"):
            assert g.get(k) == w.get(k), (g["step"], k)
    assert sum(h["synced"] for h in tr.history) == 2
    sync = state.sync
    assert_tree_equal(want["sync"].cluster, sync.cluster, "cluster")
    assert_tree_equal(want["sync"].duot, sync.duot, "duot")
    for f in ("merges", "violations", "severity", "inter_pod_gb"):
        np.testing.assert_array_equal(as_np(getattr(sync, f)),
                                      np.asarray(getattr(want["sync"], f)))
