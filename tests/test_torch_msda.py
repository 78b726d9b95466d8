"""Kernel K2's plain version, the coordinate math and the gather-accumulate
that the fused kernel computes, against the JAX package
(`ultralytics_pro_tpu/kernels/msda_pallas.py`).

Inputs are the `_problem` of tests/test_msda_kernel.py: locations in
[-0.1, 1.1] so corners fall outside the maps, hd = 8, Q not a multiple of
the Pallas tile. The Pallas kernel runs in interpret mode, as that file runs
it. Tolerance rtol = atol = 1e-5 on the sampled values, that file's own (f32
sums over 48 corners in another order); the flat corner rows are compared
exactly and their weights at 1e-6.
"""

import numpy as np
import pytest
import torch

from tests.test_msda_kernel import _problem
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch.kernels import msda_cuda


def _t(a):
    return torch.from_numpy(np.array(a))


def _coords(**kw):
    """The JAX flattened rows and weights of a _problem, and its value table (B, nh, V, hd)."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.kernels.msda_pallas import msda_flatten_coords

    values, shapes, locs, attn = _problem(**kw)
    idx, w = msda_flatten_coords(shapes, locs, attn)
    val = jnp.concatenate(values, axis=1).transpose(0, 2, 1, 3)
    return val, idx, w, (values, shapes, locs, attn)


@pytest.mark.parametrize("kw", [dict(), dict(b=1, q=19, nh=2, hd=8), dict(b=1, q=70, nh=8, hd=32)])
def test_flatten_coords_matches_jax(kw):
    _, idx, w, (_, shapes, locs, attn) = _coords(**kw)
    got_idx, got_w = msda_cuda.msda_flatten_coords(shapes, _t(locs), _t(attn))
    assert got_idx.dtype == torch.int32 and got_w.dtype == torch.float32
    assert tuple(got_idx.shape) == tuple(idx.shape)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(b=1, q=19, nh=2, hd=8)])
def test_plain_matches_xla_gather(kw):
    from ultralytics_pro_tpu.kernels.msda_pallas import msda_gather_xla

    val, idx, w, _ = _coords(**kw)
    want = np.asarray(msda_gather_xla(val, idx, w))
    got = msda_cuda.msda_sample_plain(_t(val), _t(idx), _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_matches_interpreted_pallas_kernel():
    from ultralytics_pro_tpu.kernels.msda_pallas import msda_sample_pallas

    val, idx, w, _ = _coords(b=1, q=19, nh=2, hd=8)
    want = np.asarray(msda_sample_pallas(val, idx, w, interpret=True))
    got = msda_cuda.msda_sample_plain(_t(val), _t(idx), _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_out_of_range_rows_add_zero_as_in_the_pallas_kernel():
    """An index outside [0, V) matches no one-hot column in the TPU kernel, so
    it adds 0; the plain version skips it (the fused kernel never forms such a
    row: it reads no corner outside the map). msda_gather_xla is no reference
    here: JAX's gather wraps negative indices and fills NaN past V."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.kernels.msda_pallas import msda_sample_pallas

    val, idx, w, _ = _coords(b=1, q=19, nh=2, hd=8)
    v = val.shape[2]
    rng = np.random.default_rng(3)
    bad = np.asarray(idx).copy()
    mask = rng.uniform(size=bad.shape) < 0.2
    bad[mask] = rng.choice([-1, -7, v, v + 5, 2 ** 30], size=int(mask.sum()))
    w_np = np.asarray(w) + 0.1  # every corner weighted, out-of-range ones too
    want = np.asarray(msda_sample_pallas(val, jnp.asarray(bad), jnp.asarray(w_np), interpret=True))
    got = msda_cuda.msda_sample_plain(_t(val), _t(bad), _t(w_np))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the skipped rows really contribute nothing
    keep = _t(np.where(mask, 0.0, w_np).astype(np.float32))
    np.testing.assert_allclose(got.numpy(), msda_cuda.msda_sample_plain(
        _t(val), _t(np.where(mask, 0, bad).astype(np.int32)), keep).numpy(), rtol=1e-6, atol=1e-6)


def test_multi_scale_bilinear_sample_matches_jax_reference():
    from ultralytics_pro_tpu.nn.modules.transformer import _multi_scale_bilinear_sample_reference

    values, shapes, locs, attn = _problem()
    want = np.asarray(_multi_scale_bilinear_sample_reference(values, shapes, locs, attn))
    got = msda_cuda.msda_sample_fused(torch.cat([_t(v) for v in values], 1), shapes, _t(locs), _t(attn))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """CPU tensors go to the plain version without counting a launch; a
    tensor on any other device goes to the kernel or raises, never to the
    plain version."""
    values, shapes, locs, attn = _problem(b=1, q=5, nh=2, hd=8)
    value = _t(np.concatenate(values, 1))
    before = msda_cuda.launches
    out = msda_cuda.msda_sample_fused(value, shapes, _t(locs), _t(attn))
    assert msda_cuda.launches == before and tuple(out.shape) == (1, 5, 2 * 8)
    with pytest.raises(ValueError, match="CUDA device"):
        msda_cuda.msda_sample_fused(value.to("meta"), shapes, _t(locs), _t(attn))
    assert msda_cuda.launches == before


@pytest.mark.parametrize("kw,lo,hi", [
    (dict(), -0.1, 1.1),
    (dict(b=1, q=19, nh=2, hd=8, seed=7), -0.6, 1.6),
    (dict(b=1, q=70, nh=8, hd=32, shapes=((16, 16), (8, 8), (4, 4)), seed=8), -0.1, 1.1),
    (dict(b=2, q=9, nh=3, hd=40, shapes=((5, 7), (3, 4)), p=3, seed=9), -1.0, 2.0),
])
def test_fused_plain_matches_jax_flatten_and_interpreted_pallas(kw, lo, hi):
    """The fused kernel's plain version (coordinates, then gather-accumulate)
    on the value table in the (B, V, nh, hd) layout that MSDeformAttn makes,
    against the JAX msda_flatten_coords + msda_sample_pallas (interpret mode)
    on the same inputs, with locations spread beyond [0, 1] so that corners
    fall outside the maps. Tolerance 1e-5: f32 sums over L*P*4 corners in
    another order."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.kernels.msda_pallas import msda_flatten_coords, msda_sample_pallas

    values, shapes, locs, attn = _problem(**kw)
    b, q, nh, nl, p, _ = locs.shape
    locs = np.random.default_rng(kw.get("seed", 0) + 100).uniform(lo, hi, locs.shape).astype(np.float32)
    value = jnp.concatenate(values, axis=1)  # (B, V, nh, hd)
    idx, w = msda_flatten_coords(shapes, jnp.asarray(locs), attn)
    want = msda_sample_pallas(value.transpose(0, 2, 1, 3), idx, w, interpret=True)  # (B, nh, Q, hd)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, q, -1)
    got = msda_cuda.msda_sample_fused(_t(value), shapes, _t(locs), _t(attn))
    assert tuple(got.shape) == want.shape == (b, q, nh * value.shape[-1])
    assert (np.asarray(w) == 0).any()  # some corners fell outside a map
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
