"""B.3's redesign on the CPU: the per-thread twin (each thread's counts
over its strided columns, summed per row) against ``histogram_ref`` and
the reference's Pallas kernel in interpret mode, bit for bit — values
below lo, at and above hi, far out of range and NaN, all-zero masks, no
mask, bool masks, B that is not a multiple of the CTA's threads; the
host-computed params against the device ones and JAX's; and
``ops.histogram`` adding into a running buffer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import histogram as jhg
from repro_torch.kernels import histogram as thg
from repro_torch.kernels import ops

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _observations(rng, m, b, lo, hi):
    v = rng.uniform(lo - 5.0, hi + 5.0, (m, b)).astype(np.float32)
    v[:, ::7] = hi                        # exactly at hi -> top bin
    v[:, 1::11] = 1e9                     # far beyond hi
    v[:, 2::13] = -1e9                    # far below lo
    v[:, 3::17] = np.nan                  # NaN -> bin 0
    v[:, 4::19] = lo                      # exactly at lo -> bin 0
    mask = (rng.random((m, b)) < 0.7).astype(np.int32)
    mask[-1] = 0                          # an all-zero mask row
    return v, mask


def _pallas(v, mask, lo, hi, n_bins):
    params = jhg.metric_params(jnp.asarray(lo), jnp.asarray(hi), n_bins)
    vals, msk = jhg.pack_observations(jnp.asarray(v), jnp.asarray(mask), block=128)
    return np.asarray(jhg.histogram_pallas(vals, msk, params, n_bins=n_bins,
                                           block=128, interpret=True))


@pytest.mark.parametrize("b", [1, 130, 513, 4097, 9000])
@pytest.mark.parametrize("n_bins", [4, 64])
def test_per_thread_twin_matches_plain_and_pallas(b, n_bins):
    rng = np.random.default_rng(b * n_bins)
    lo = np.asarray([0.0, -3.5, 10.0], np.float32)
    hi = np.asarray([1024.0, 7.25, 11.0], np.float32)
    v, mask = _observations(rng, 3, b, lo[:, None], hi[:, None])
    params = thg.row_params(lo, hi, n_bins, 3, "cpu")
    want = _pallas(v, mask, lo, hi, n_bins)
    vt, mt = torch.from_numpy(v), torch.from_numpy(mask)
    np.testing.assert_array_equal(thg.histogram_ref(vt, mt, params, n_bins=n_bins).numpy(),
                                  want)
    for msk in (mt, mt > 0):
        got = thg.histogram_per_thread(vt, msk, params, n_bins=n_bins)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(msk.dtype))
    assert int(want[-1].sum()) == 0


@pytest.mark.parametrize("b", [1, 512, 4097])
def test_no_mask_counts_every_observation(b):
    """``mask=None`` in the plain version and its twin: the reference
    with a mask of ones."""
    rng = np.random.default_rng(b)
    v, _ = _observations(rng, 2, b, 0.0, 64.0)
    params = thg.row_params(0.0, 64.0, 16, 2, "cpu")
    want = _pallas(v, np.ones((2, b), np.int32), [0.0, 0.0], [64.0, 64.0], 16)
    vt = torch.from_numpy(v)
    np.testing.assert_array_equal(thg.histogram_ref(vt, None, params, n_bins=16).numpy(),
                                  want)
    np.testing.assert_array_equal(
        thg.histogram_per_thread(vt, None, params, n_bins=16).numpy(), want)
    assert int(want.sum()) == 2 * b


@pytest.mark.parametrize("lo,hi,n_bins", [(0.0, 1024.0, 64), (-3.5, 7.25, 16),
                                          (0.0, 3.0, 7), (1.0, 1.0, 4)])
def test_host_params_equal_device_and_reference(lo, hi, n_bins):
    """Host scalars and arrays (cached, one tensor per range and row
    count) and tensors on the device: the same f32 bits as the
    reference's ``metric_params``."""
    want = np.asarray(jhg.metric_params(jnp.float32(lo), jnp.float32(hi), n_bins))
    one = thg.row_params(lo, hi, n_bins, 1, "cpu")
    assert one is thg.row_params(lo, hi, n_bins, 1, "cpu")
    np.testing.assert_array_equal(one.numpy().view(np.int32), want.view(np.int32))
    arr = thg.row_params(np.asarray([lo, lo]), np.asarray([hi, hi]), n_bins, 2, "cpu")
    assert arr is thg.row_params(np.asarray([lo, lo]), np.asarray([hi, hi]), n_bins, 2,
                                 "cpu")
    assert arr.is_contiguous()
    np.testing.assert_array_equal(arr.numpy().view(np.int32),
                                  np.repeat(want, 2, axis=0).view(np.int32))
    wide = thg.row_params(lo, hi, n_bins, 3, "cpu")
    np.testing.assert_array_equal(wide.numpy().view(np.int32),
                                  np.repeat(want, 3, axis=0).view(np.int32))
    dev = thg.row_params(torch.tensor(lo), torch.tensor(hi), n_bins, 2, "cpu")
    assert dev.is_contiguous()
    np.testing.assert_array_equal(dev.numpy().view(np.int32),
                                  np.repeat(want, 2, axis=0).view(np.int32))


def test_ops_histogram_accumulates_and_takes_bool_or_no_mask():
    rng = np.random.default_rng(3)
    v, mask = _observations(rng, 2, 300, 0.0, 64.0)
    vt = torch.from_numpy(v)
    lo, hi = np.asarray([0.0, 0.0], np.float32), np.asarray([64.0, 64.0], np.float32)
    once = ops.histogram(vt, lo=lo, hi=hi, n_bins=16, mask=torch.from_numpy(mask),
                         impl="torch")
    run = torch.zeros((3, 16), dtype=torch.int32)
    for _ in range(2):
        ops.histogram(vt, lo=lo, hi=hi, n_bins=16, mask=torch.from_numpy(mask) > 0,
                      out=run[:2], impl="torch")
    np.testing.assert_array_equal(run[:2].numpy(), 2 * once.numpy())
    assert int(run[2].sum()) == 0
    row = ops.histogram(vt[0], lo=0.0, hi=64.0, n_bins=16, out=run[2], impl="torch")
    assert row.data_ptr() == run[2].data_ptr()
    want = _pallas(v[:1], np.ones((1, 300), np.int32), [0.0], [64.0], 16)[0]
    np.testing.assert_array_equal(run[2].numpy(), want)
    # Tensor bounds (params on the device) broadcast over the rows.
    by_tensor = ops.histogram(vt, lo=torch.tensor(0.0), hi=torch.tensor(64.0), n_bins=16,
                              mask=torch.from_numpy(mask), impl="torch")
    np.testing.assert_array_equal(by_tensor.numpy(), once.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        thg.histogram_cuda(vt, None, thg.row_params(0.0, 64.0, 16, 2, "cpu"), n_bins=16)
