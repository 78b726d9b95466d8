"""The port's v8 modules against the JAX package's, on random weights.

Each JAX module is initialised, its variables are replaced by seeded numpy
values (BatchNorm statistics included, so eval-mode BN is not the identity),
and the same values go into the port's module through
`jax_to_torch_state_dict` with a strict load. Inputs are seeded numpy arrays,
NHWC for JAX and NCHW for the port. Tolerance: atol 1e-5 on activations,
logits and scores (f32, summation order differs between XLA and PyTorch);
decoded boxes are in pixels and get atol 1e-5 times the level's stride.
"""

import numpy as np
import pytest
import torch

from ultralytics_pro_tpu_torch.nn.modules import C2f, SPPF, Conv, Detect, decode_single_label
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two torch threads per test module, its module-scoped fixtures
    included (an autouse fixture comes first in its scope): the suite runs
    several workers on one machine, and torch's default of one thread per
    core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def randomize(variables, seed):
    """Seeded numpy values for every leaf of a flax {'params', 'batch_stats'} tree."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        return rng.normal(0, 0.2, shape)  # bias, mean

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                leaf(k, np.shape(v)).astype(np.float32) for k, v in tree.items()}

    return {c: walk(variables[c]) for c in ("params", "batch_stats") if c in variables}


def carry(jax_module, x_nhwc, torch_module, seed=0):
    """Random JAX variables for jax_module, loaded into torch_module; returns them."""
    import jax

    v = randomize(jax_module.init(jax.random.PRNGKey(0), x_nhwc), seed)
    torch_module.load_state_dict(jax_to_torch_state_dict(v))  # strict
    torch_module.eval()
    return v


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("spec", ["gelu", "nn.GELU()"])
def test_gelu_is_the_tanh_form_of_jax(spec):
    """The YAML activation "gelu" is jax.nn.gelu's default, the tanh form."""
    import jax

    from ultralytics_pro_tpu_torch.nn.modules.conv import resolve_act

    x = np.random.default_rng(9).normal(0, 3, (4096,)).astype(np.float32)
    got = resolve_act(spec)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("k,s", [(1, 1), (3, 2)])
def test_conv(k, s):
    from ultralytics_pro_tpu.nn.modules.conv import Conv as JConv

    x = np.random.default_rng(1).normal(0, 1, (2, 16, 16, 8)).astype(np.float32)
    jm, tm = JConv(c2=16, k=k, s=s), Conv(8, 16, k, s)
    v = carry(jm, x, tm)
    ref = np.asarray(jm.apply(v, x))
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shortcut", [True, False])
def test_c2f(shortcut):
    from ultralytics_pro_tpu.nn.modules.block import C2f as JC2f

    x = np.random.default_rng(2).normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jm, tm = JC2f(c2=32, n=2, shortcut=shortcut), C2f(16, 32, 2, shortcut)
    v = carry(jm, x, tm)
    ref = np.asarray(jm.apply(v, x))
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_sppf():
    from ultralytics_pro_tpu.nn.modules.block import SPPF as JSPPF

    x = np.random.default_rng(3).normal(0, 1, (2, 8, 8, 32)).astype(np.float32)
    jm, tm = JSPPF(c2=32, k=5), SPPF(32, 32, 5)
    v = carry(jm, x, tm)
    ref = np.asarray(jm.apply(v, x))
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_detect_decode_and_single_label():
    import jax

    from ultralytics_pro_tpu.nn.modules.head import Detect as JDetect
    from ultralytics_pro_tpu.nn.modules.head import decode_single_label as jax_decode_single

    rng = np.random.default_rng(4)
    strides, nc, chs = (8, 16, 32), 5, (16, 32, 64)
    feats = [rng.normal(0, 1, (2, 64 // s, 64 // s, c)).astype(np.float32)
             for s, c in zip(strides, chs)]
    jm = JDetect(nc=nc, strides=strides)
    v = randomize(jm.init(jax.random.PRNGKey(0), feats), 5)
    tm = Detect(nc=nc, ch=chs)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    tm.stride = torch.tensor(strides, dtype=torch.float32)
    tm.eval()

    y_ref, aux = jm.apply(v, feats)
    with torch.no_grad():
        y, raw = tm([nchw(f) for f in feats])
    for r, rr in zip(raw, aux["feats"]):
        np.testing.assert_allclose(to_nhwc(r), np.asarray(rr), atol=1e-5, rtol=0)
    y, y_ref = y.numpy(), np.asarray(y_ref)
    assert y.shape == y_ref.shape == (2, sum((64 // s) ** 2 for s in strides), 4 + nc)
    box_tol = np.concatenate([np.full((64 // s) ** 2, 1e-5 * s) for s in strides])[None, :, None]
    assert (np.abs(y[..., :4] - y_ref[..., :4]) <= box_tol).all()
    np.testing.assert_allclose(y[..., 4:], y_ref[..., 4:], atol=1e-5, rtol=0)

    b4, cf, cl = decode_single_label(raw, strides, nc)
    rb, rc, rl = jax_decode_single(aux["feats"], strides, nc)
    assert (np.abs(b4.numpy() - np.asarray(rb)) <= box_tol).all()
    np.testing.assert_allclose(cf.numpy(), np.asarray(rc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cl.numpy(), np.asarray(rl))
    # the fused decode agrees with the full one
    np.testing.assert_array_equal(b4.numpy(), y[..., :4])
    np.testing.assert_allclose(cf.numpy(), y[..., 4:].max(-1), atol=1e-7, rtol=0)
