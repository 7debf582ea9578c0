"""The clock chain's batch-parallel designs == the plain walk == JAX's
scan: the segment twin (max-plus maps per segment, a carry across them,
a replay of each) and the level twin (dependence levels run a level at a
time) against ``vclock_chain_ref`` and the reference's
``apply_op_batch(with_clocks=True)``, exactly, on adversarial mixes; the
level rule against the longest path of the explicit dependence graph;
and the kernel's plans (segment sizes within the CTA's shared memory and
threads, the design per shape)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import xstcc as jx
from repro_torch.kernels import vclock_chain as vch

from torch_port_helpers import CHAIN_MIXES, as_np, chain_mix

torch.set_num_threads(1)

# (mix, B, C, P): every mix at P in {1, 3, 12}; B = 1; B not a multiple
# of any segment length; C > B; C < B.
CASES = [
    ("one_client", 70, 8, 3),
    ("one_replica_writes", 90, 12, 3),
    ("reads_once", 24, 24, 12),
    ("reads_once", 10, 40, 3),
    ("reads_repeat", 100, 6, 12),
    ("random", 1, 5, 1),
    ("random", 77, 16, 1),
    ("random", 130, 9, 3),
    ("random", 13, 40, 12),
    ("workload_a", 150, 16, 3),
]


def _inputs(mix, b, c, p, seed=0):
    rng = np.random.default_rng(seed + 17 * b + c)
    cl, rp, w = chain_mix(mix, rng, b, c, p)
    svc = rng.integers(0, 40, (c, c)).astype(np.int32)
    rvc = rng.integers(0, 40, (p, c)).astype(np.int32)
    return cl, rp, w, svc, rvc


def _jax_clocks(cl, rp, w, svc, rvc):
    """The reference's scan through ``apply_op_batch(with_clocks=True)``."""
    p, c = rvc.shape
    st = jx.make_cluster(p, c, 1, pending_cap=max(8, cl.shape[0]))
    st = st._replace(session_vc=jnp.asarray(svc), replica_vc=jnp.asarray(rvc))
    out = jx.apply_op_batch(
        st, client=jnp.asarray(cl), replica=jnp.asarray(rp),
        resource=jnp.zeros(cl.shape, jnp.int32), kind=jnp.asarray(w),
        ingest="dense", with_clocks=True)
    return (np.asarray(out.state.session_vc), np.asarray(out.state.replica_vc),
            np.asarray(out.vc))


@pytest.mark.parametrize("mix,b,c,p", CASES, ids=lambda v: str(v))
def test_twins_match_plain_and_reference(mix, b, c, p):
    cl, rp, w, svc, rvc = _inputs(mix, b, c, p)
    args = [torch.from_numpy(x) for x in (cl, rp, w, svc, rvc)]
    want = [as_np(x) for x in vch.vclock_chain_ref(*args)]
    for name, got in (
        ("segments", vch.vclock_chain_segments(*args)),
        ("segments, 3 x 8-op segments per chunk",
         vch.vclock_chain_segments(*args, plan=(8, 3, min(8, c) + p))),
        ("levels", vch.vclock_chain_levels(*args)),
    ):
        for k, (g, wnt) in enumerate(zip(got, want)):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(as_np(g), wnt, err_msg=f"{name}: output {k}")
    for k, (j, wnt) in enumerate(zip(_jax_clocks(cl, rp, w, svc, rvc), want)):
        np.testing.assert_array_equal(j, wnt, err_msg=f"reference: output {k}")


def test_empty_batch_keeps_the_clocks():
    cl, rp, w, svc, rvc = _inputs("random", 0, 5, 3)
    args = [torch.from_numpy(x) for x in (cl, rp, w, svc, rvc)]
    for fn in (vch.vclock_chain_ref, vch.vclock_chain_segments, vch.vclock_chain_levels):
        s, r, v = fn(*args)
        assert v.shape == (0, 5)
        np.testing.assert_array_equal(as_np(s), svc)
        np.testing.assert_array_equal(as_np(r), rvc)


def _longest_path_levels(cl, rp, w):
    """Levels as the longest path of the explicit dependence graph: op j
    precedes op i > j on the same client, or on the same replica when
    either writes."""
    b = cl.shape[0]
    lv = np.zeros(b, np.int64)
    for i in range(b):
        dep = [lv[j] for j in range(i)
               if cl[j] == cl[i] or (rp[j] == rp[i] and (w[i] or w[j]))]
        lv[i] = 1 + max(dep, default=0)
    return lv


@pytest.mark.parametrize("mix", CHAIN_MIXES)
def test_levels_are_the_dependence_graph_longest_paths(mix):
    cl, rp, w = chain_mix(mix, np.random.default_rng(5), 60, 60, 3)
    level, first = vch.chain_levels(torch.from_numpy(cl), torch.from_numpy(rp),
                                    torch.from_numpy(w), 60)
    np.testing.assert_array_equal(level.numpy(), _longest_path_levels(cl, rp, w))
    seen = set()
    for i, ci in enumerate(cl):
        assert bool(first[i]) == (ci not in seen)
        seen.add(ci)
    # Within a level: distinct clients, and a written replica row is
    # touched by no other op.
    for lv in set(level.tolist()):
        i = np.nonzero(level.numpy() == lv)[0]
        assert len(set(cl[i])) == len(i)
        for k in i[w[i] > 0]:
            assert (rp[i] == rp[k]).sum() == 1
    if mix == "reads_once":
        assert int(level.max()) == 1   # the serving read batch: one level


@pytest.mark.parametrize("b,c,p", [(1, 1, 1), (128, 16, 3), (4096, 64, 3),
                                   (5000, 256, 64), (300, 200, 12), (100_000, 64, 3),
                                   (257, 255, 1), (40, 3, 64)])
def test_segment_plan_fits_the_cta(b, c, p):
    seg_len, n_seg, umax = vch.segment_plan(b, c, p)
    assert 1 <= seg_len <= 128 and n_seg >= 1
    assert umax == min(seg_len, c) + p <= 255
    assert n_seg * -(-umax // 4) <= vch.SEG_THREADS * vch.SEG_PAIRS
    assert vch.seg_smem(c, p, seg_len, n_seg, umax) <= vch.SMEM_MAX
    assert n_seg <= max(1, -(-b // seg_len))


def test_design_per_shape_and_depth():
    assert vch.design_for(128, 16, 3) == "small"
    assert vch.design_for(vch.SMALL_MAX + 1, 16, 3) == "segments"
    assert vch.design_for(4096, 64, 3) == "segments"
    assert vch.design_for(4096, 64, 65) == "levels"
    assert vch.design_for(16_384, 16_384, 12) == "levels"
    assert vch.design_for(1, 4096, 3) == "levels"
    cl, rp, w = (torch.from_numpy(x) for x in
                 chain_mix("reads_once", np.random.default_rng(0), 500, 500, 12))
    assert vch.serial_depth("levels", cl, rp, w, 500, 12) == 500 + 1
    assert vch.serial_depth("small", cl, rp, w, 500, 12) == 500
    seg_len, n_seg, _ = vch.segment_plan(500, 500, 12)
    assert vch.serial_depth("segments", cl, rp, w, 500, 12) == (
        -(-500 // (n_seg * seg_len)) * (2 * seg_len + n_seg))


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_designs():
    args = [torch.from_numpy(x) for x in _inputs("random", 8, 4, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        vch.vclock_chain_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        vch.vclock_chain_cuda(*args, design="levels")
