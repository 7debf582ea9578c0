"""The port's flash attention (plain version, dispatch, layouts) against
the JAX reference's oracle ``flash_attention_ref`` and its Pallas kernel
in interpret mode, on the same numpy inputs.  Tolerances are the
reference's own (``tests/test_kernels.py``): atol = rtol = 2e-5 in f32,
2e-2 in bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)

# (b, h, hkv, s, hd, causal, window, dtype): the shapes of the reference's
# FA_CASES cut to S <= 64 (interpret mode runs the kernel body in
# Python), plus gemma-2b's MQA group of 8 at head_dim 256 and qwen2-7b's
# group of 7.
CASES = [
    (2, 4, 2, 64, 64, True, 0, "float32"),
    (1, 2, 1, 32, 128, True, 0, "float32"),
    (1, 4, 4, 64, 64, False, 0, "float32"),
    (2, 2, 2, 64, 64, True, 16, "float32"),
    (1, 8, 2, 48, 64, True, 0, "bfloat16"),
    (1, 1, 1, 32, 256, True, 0, "float32"),
    (1, 8, 1, 32, 256, True, 0, "bfloat16"),
    (1, 7, 1, 32, 128, True, 0, "bfloat16"),
]


def _inputs(case, seed=0):
    b, h, hkv, s, hd, _, _, dtype = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _close(got, want, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_reference_oracle(case):
    *_, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(case)
    got = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_pallas_interpret(case):
    """Against the Pallas kernel itself, at 16-row blocks so the online
    softmax runs over several k blocks and the causal skip fires."""
    *_, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=1)
    want = pallas_flash(jq, jk, jv, causal=causal, window=window, block_q=16,
                        block_k=16, interpret=True)
    _close(fa.flash_attention_ref(q, k, v, causal=causal, window=window), want, dtype)


def test_non_causal_window_follows_ref():
    """Without ``causal`` the window is ignored, as in ``ref.py`` (the
    Pallas kernel would apply it; that case is ambiguous and not held
    against the kernel)."""
    case = (1, 2, 2, 32, 64, False, 8, "float32")
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=2)
    got = fa.flash_attention_ref(q, k, v, causal=False, window=8)
    _close(got, jax_ref(jq, jk, jv, causal=False, window=8), "float32")
    _close(got, fa.flash_attention_ref(q, k, v, causal=False, window=0).numpy(), "float32")


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[6]], ids=str)
def test_ops_layouts_match_reference_ops(case):
    """``ops.flash_attention`` in both layouts against the reference's
    ``ops.flash_attention`` (Pallas in interpret mode on the CPU)."""
    *_, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=3)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                layout="bhsd", block_q=16, block_k=16)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, layout="bhsd",
                              block_q=16, block_k=16)
    _close(got, want, dtype)
    sw = [x.transpose(1, 2) for x in (q, k, v)]
    got_bshd = ops.flash_attention(*sw, causal=causal, window=window, layout="bshd")
    assert got_bshd.shape == sw[0].shape
    assert torch.equal(got_bshd.transpose(1, 2), got)


def test_non_dividing_length_raises_like_the_reference():
    """S = 48 with 32-row blocks: the reference asserts, the port raises
    ``ValueError``; a block of min(block, S) always divides."""
    case = (1, 2, 2, 48, 64, True, 0, "float32")
    (jq, jk, jv), (q, k, v) = _inputs(case)
    with pytest.raises(AssertionError):
        pallas_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q, k, v, layout="bhsd", block_q=32, block_k=32)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q, k, v, layout="bhsd", block_q=16, block_k=32)
    assert ops.flash_attention(q, k, v, layout="bhsd").shape == q.shape
    with pytest.raises(ValueError, match="layout"):
        ops.flash_attention(q, k, v, layout="bsdh")


def test_no_quiet_fallback_and_no_backward():
    """CPU tensors under ``impl="cuda"`` raise (no fallback to the plain
    version); the kernel has no backward and says so."""
    (_, (q, k, v)) = _inputs(CASES[1])
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, layout="bhsd", impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(RuntimeError, match="backward"):
        fa.flash_attention_cuda(q.requires_grad_(), k, v)
    assert ops.launch_counts()["flash_attention"] == 0


# -- the bf16 kernel's work list and its tile numerics -------------------------


@pytest.mark.parametrize("b,h,s,t,causal", [
    (1, 8, 2048, 2048, True), (2, 3, 300, 300, True), (1, 4, 100, 300, False),
    (2, 2, 300, 70, True), (1, 1, 1, 1, True),
])
def test_flash_schedule_covers_every_tile_once(b, h, s, t, causal):
    """Every (b, h, q tile) exactly once, tiles with more key blocks
    first, ties in index order."""
    sched = fa.flash_schedule(b, h, s, t, causal=causal)
    n_qt = -(-s // fa.BLOCK_Q)
    assert sorted(sched) == list(range(b * h * n_qt))

    def work(i):
        end = min(t, (i % n_qt + 1) * fa.BLOCK_Q) if causal else t
        return -(-end // fa.BLOCK_K)

    keys = [(-work(i), i) for i in sched]
    assert keys == sorted(keys)


def _inputs_st(case, seed):
    """Like ``_inputs`` with S != T allowed: (b, h, hkv, s, t, hd, ...)."""
    b, h, hkv, s, t, hd, _, _, dtype = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, s, hd), (b, hkv, t, hd), (b, hkv, t, hd))]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, tt


@pytest.mark.parametrize("case", CASES, ids=str)
def test_blocked_twin_matches_oracle_and_pallas(case):
    """The bf16 kernel's numerics (P rounded to bf16 before P . V) stay
    within the contract of the oracle and of the Pallas kernel."""
    *_, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=4)
    got = fa.flash_attention_blocked(q, k, v, causal=causal, window=window, block_k=16)
    assert got.dtype == q.dtype
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window), dtype)
    want = pallas_flash(jq, jk, jv, causal=causal, window=window, block_q=16,
                        block_k=16, interpret=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", [
    (1, 2, 1, 200, 70, 64, True, 16, "bfloat16"),
    (1, 4, 2, 130, 130, 32, True, 0, "bfloat16"),
    (1, 3, 3, 60, 150, 128, False, 0, "bfloat16"),
], ids=str)
def test_blocked_twin_ragged_lengths_and_masked_rows(case):
    """Lengths off the 64-key block, S != T, and rows whose keys are all
    masked (S > T with a window: uniform weights, as in the oracle)."""
    *_, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs_st(case, seed=5)
    got = fa.flash_attention_blocked(q, k, v, causal=causal, window=window)
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("s", [512, 1024])
def test_blocked_twin_at_gemma_width(s):
    """gemma-2b's attention (8 query heads over one KV head of 256) in
    bf16 with the kernel's 64-key blocks, against the oracle."""
    case = (1, 8, 1, s, 256, True, 0, "bfloat16")
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=6)
    got = fa.flash_attention_blocked(q, k, v)
    _close(got, jax_ref(jq, jk, jv, causal=True), "bfloat16")
