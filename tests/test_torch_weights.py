"""Weights carried between the JAX package and the port.

JAX variables -> port state_dict -> JAX variables must round-trip exactly,
both through the port's own inverse and through the JAX package's
`load_torch_state_dict`, and every parameter and buffer of the port must be
assigned by the carried state_dict (strict load, values checked).
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel
from ultralytics_pro_tpu_torch.utils.weights import (
    jax_to_torch_state_dict,
    load_torch_state_dict_file,
    torch_state_dict_to_jax,
)


@pytest.fixture(scope="module")
def jax_variables():
    import jax

    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel

    m = JModel("yolov8n.yaml")
    v = m.init_params(imgsz=64)
    # random BN statistics too, so a dropped or swapped buffer cannot pass
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.1, np.shape(a)).astype(np.float32), v)
    return {c: v[c] for c in ("params", "batch_stats")}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), np.asarray(v)


def test_round_trip_through_port_is_exact(jax_variables):
    sd = jax_to_torch_state_dict(jax_variables)
    model = DetectionModel("yolov8n.yaml")
    model.load_state_dict(sd)  # strict: a missing or left-over key raises
    back = torch_state_dict_to_jax(model.state_dict())
    a, b = dict(_flat(jax_variables)), dict(_flat(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_round_trip_through_jax_importer_is_exact(jax_variables):
    from ultralytics_pro_tpu.utils.torch_import import load_torch_state_dict

    model = DetectionModel("yolov8n.yaml")
    model.load_state_dict(jax_to_torch_state_dict(jax_variables))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = load_torch_state_dict(jax_variables, sd, strict=True)
    a, b = dict(_flat(jax_variables)), dict(_flat(back))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_every_parameter_and_buffer_is_assigned(jax_variables):
    sd = jax_to_torch_state_dict(jax_variables)
    model = DetectionModel("yolov8n.yaml")
    own = model.state_dict()
    assert sd.keys() == own.keys()
    model.load_state_dict(sd)
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape and torch.equal(v, sd[k].to(v.dtype)), k
    n_jax = sum(a.size for _, a in _flat(jax_variables))
    n_port = sum(v.numel() for k, v in own.items()
                 if not k.endswith(("num_batches_tracked", "dfl.conv.weight")))
    assert n_jax == n_port


def test_fixture_state_dict_loads_strict():
    sd = load_torch_state_dict_file(f"{FIXTURES}/model_yolov8n.npz")
    model = DetectionModel("yolov8n.yaml")
    model.load_state_dict(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k


def test_strict_load_raises_on_missing_or_extra_key(jax_variables):
    sd = jax_to_torch_state_dict(jax_variables)
    model = DetectionModel("yolov8n.yaml")
    missing = dict(sd)
    missing.pop("model.0.conv.weight")
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict(missing)
    with pytest.raises(RuntimeError, match="Unexpected"):
        model.load_state_dict({**sd, "model.99.conv.weight": torch.zeros(1)})


def test_nested_layers_token_is_an_mlp_layer():
    """Only a tree's first `layers_N` is the model's layer N; a nested one is
    the MLP's `layers.N` (nn.ModuleList), both ways."""
    rng = np.random.default_rng(1)
    tree = {"params": {"layers_28": {"dec_bbox_head_0": {
        "layers_0": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                     "bias": rng.normal(size=(5,)).astype(np.float32)}}}}}
    sd = jax_to_torch_state_dict(tree)
    assert sorted(sd) == ["model.28.dec_bbox_head.0.layers.0.bias", "model.28.dec_bbox_head.0.layers.0.weight"]
    assert np.array_equal(sd["model.28.dec_bbox_head.0.layers.0.weight"].numpy(),
                          tree["params"]["layers_28"]["dec_bbox_head_0"]["layers_0"]["kernel"].T)
    back = torch_state_dict_to_jax(sd)
    a, b = dict(_flat(tree)), dict(_flat(back))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_attention_kernels_round_trip_on_the_aifi_tree():
    """flax attention's 3-D kernels go to nn.MultiheadAttention's layout:
    query/key/value (C, nh, hd) -> rows of in_proj_weight (3C, C), their (nh,
    hd) biases -> in_proj_bias, out (nh, hd, C) -> out_proj.weight (C, C);
    and back again exactly."""
    import jax

    from tests.test_torch_modules import randomize
    from ultralytics_pro_tpu.nn.modules.transformer import AIFI as JAIFI
    from ultralytics_pro_tpu_torch.nn.modules import AIFI

    c, nh = 32, 4
    x = np.zeros((1, 2, 3, c), np.float32)
    v = randomize(JAIFI(cm=64, num_heads=nh).init(jax.random.PRNGKey(0), x), 3)
    sd = jax_to_torch_state_dict(v)
    ma = v["params"]["ma"]
    w = sd["ma.in_proj_weight"].numpy()
    assert w.shape == (3 * c, c) and sd["ma.in_proj_bias"].shape == (3 * c,)
    for i, part in enumerate(("query", "key", "value")):
        assert np.array_equal(w[i * c:(i + 1) * c], ma[part]["kernel"].reshape(c, c).T)
        assert np.array_equal(sd["ma.in_proj_bias"][i * c:(i + 1) * c].numpy(), ma[part]["bias"].reshape(-1))
    assert np.array_equal(sd["ma.out_proj.weight"].numpy(), ma["out"]["kernel"].reshape(c, c).T)
    model = AIFI(c, 64, nh)
    model.load_state_dict(sd)  # strict
    back = torch_state_dict_to_jax(model.state_dict(), num_heads=nh)
    a, b = dict(_flat(v)), dict(_flat(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def test_rtdetr_l_tree_is_carried_whole():
    """Every one of the 847 leaves of the JAX rtdetr-l tree (shapes from
    jax.eval_shape, so no forward runs) lands on the port's state_dict, which
    loads strict with nothing left over; the round trip is exact and the
    sizes are the JAX package's: 33,037,932 values, 32,970,732 parameters."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel

    jm = JModel("rtdetr-l.yaml")
    shapes = jax.eval_shape(partial(jm.module.init, train=True), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 640, 640, 3), jnp.float32))
    rng = np.random.default_rng(5)
    v = {c: jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes[c])
         for c in ("params", "batch_stats")}
    flat = dict(_flat(v))
    assert len(flat) == 847 and sum(a.size for a in flat.values()) == 33_037_932
    sd = jax_to_torch_state_dict(v)
    model = DetectionModel("rtdetr-l.yaml")
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)  # strict
    assert sum(p.numel() for p in model.parameters()) == 32_970_732
    for k in ("model.28.decoder.layers.3.cross_attn.sampling_offsets.weight",
              "model.28.input_proj.0.1.running_mean", "model.11.ma.in_proj_weight",
              "model.28.enc_output.1.weight", "model.28.denoising_class_embed.weight"):
        assert k in sd, k
    back = dict(_flat(torch_state_dict_to_jax(model.state_dict())))
    assert back.keys() == flat.keys()
    for k in flat:
        assert np.array_equal(flat[k], back[k]), k
