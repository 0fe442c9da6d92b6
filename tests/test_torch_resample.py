"""The port's plane resampling (bhr_tpu_torch/ops/resample.py) against
bhr_tpu/ops/resample.py on the same seeded planes. Every helper is the same
expression tree in fp32, so the values are expected bit-equal; the stated
tolerance is 1e-7 (XLA on the CPU may contract a multiply-add)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu.ops import resample as jr
from bhr_tpu_torch.ops import resample as tr

ATOL = 1e-7


def _plane(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("factor", [2, 3, 4])
@pytest.mark.parametrize("low,out", [((7, 11), None), ((9, 5), "crop"), ((1, 6), None)],
                         ids=["7x11", "9x5-cropped", "1x6"])
def test_upsample_bilinear_equals_jax(factor, low, out):
    """Non-dividing output shapes are crops of the factor-times plane:
    (lh * f - (f - 1), lw * f - 1) here, as ceil-divided low grids give."""
    plane = _plane(low, factor)
    out_shape = ((low[0] * factor - (factor - 1), low[1] * factor - 1) if out else
                 (low[0] * factor, low[1] * factor))
    got = tr.upsample_bilinear(torch.from_numpy(plane), factor, out_shape).numpy()
    want = np.asarray(jr.upsample_bilinear(jnp.asarray(plane), factor, out_shape))
    assert got.shape == out_shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # phase 0 is a bit-exact copy of the low samples
    np.testing.assert_array_equal(got[::factor, ::factor],
                                  plane[: got[::factor].shape[0], : got[0, ::factor].shape[0]])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_axis_equals_jax(axis, factor):
    plane = _plane((6, 8), 10 + axis)
    got = tr.upsample_axis(torch.from_numpy(plane), factor, axis).numpy()
    np.testing.assert_allclose(got, np.asarray(jr.upsample_axis(jnp.asarray(plane), factor, axis)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [-1, 0, 1])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_equals_jax(s, axis):
    plane = _plane((5, 7), 20)
    got = tr.shift(torch.from_numpy(plane), s, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(jr.shift(jnp.asarray(plane), s, axis)))
    idx = np.clip(np.arange(plane.shape[axis]) + s, 0, plane.shape[axis] - 1)
    np.testing.assert_array_equal(got, np.take(plane, idx, axis=axis))


def test_shift_refuses_other_offsets():
    with pytest.raises(ValueError):
        tr.shift(torch.zeros(3, 3), 2, 0)


def test_neighbor_max_equals_jax():
    plane = _plane((9, 13), 30)
    got = tr.neighbor_max(torch.from_numpy(plane)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jr.neighbor_max(jnp.asarray(plane))))
    mask = np.zeros((9, 13), np.float32)
    mask[4, 6] = 1.0
    dil = tr.neighbor_max(torch.from_numpy(mask)).numpy()
    assert dil.sum() == 9 and dil[3:6, 5:8].all()


@pytest.mark.parametrize("stride,offset", [(2, 0), (2, 1), (3, 0)])
def test_subsample_equals_jax_matrix_form(stride, offset):
    """The strided slice equals bhr_tpu's two one-hot matrix products."""
    plane = _plane((11, 14), 40)
    got = tr.subsample(torch.from_numpy(plane), stride, offset).numpy()
    np.testing.assert_array_equal(got, np.asarray(jr.subsample_mm(jnp.asarray(plane), stride,
                                                                  offset)))
