"""Shared code of the CPU tests of yolov8-att, MAF-YOLOv2 and Hyper-YOLO
(tests/test_torch_att_maf_hyper_*.py).

Seeding. `tests/test_torch_modules.py:randomize` draws every leaf that is
not a `kernel`, a `scale` or a `var` as N(0, 0.2). That seeds GRN's `gamma`
and `beta` and UniRepLKNetBlock's layer-scale `gamma` away from the 0 and
1e-6 they start at, as a parity check needs (at init the MAF heads'
large-kernel block changes no output). It would also draw DCNv2's and
DeformConvDW's bare `weight` kernels at 0.2, several times a fan-in-scaled
kernel, which blows the activations up along the neck; `seeded` redraws
them by their fan-in, N(0, 1 / sqrt(kh kw Cin)), as `randomize` draws a
`kernel`, without changing `randomize` (the other tests' data stays).

The whole-model tests (`model_tests`): each YAML at scale n and 64 px; the
JAX package's seeded variables (their layout from `jax.eval_shape` of the
flax module's init at 64 px) load into the port strictly and carry back
to the same flax tree; the port's forward meets the JAX flax module's
`apply` on two seeded images: boxes within 1e-3 px, scores within 1e-5,
the other columns (mask coefficients, keypoints, angles), the prototypes
and each level's raw map within 1e-5 of their largest magnitude (the CSP
zoo's bounds, tests/torch_csp_zoo.py). maf-yolov2's v10Detect gives its
(B, 300, 6) top-k rows, held to the JAX rows the same way, its
one-to-one maps too. Hyper-YOLO's hypergraph layer reports the incidence
share of its input and the pairs whose distance lies within 1e-4
(relative) of the threshold; the port's incidence on that input equals a
float64 one outside those pairs.

The trainer tests (`train_tests`): one optimizer step as
tests/torch_attn_zoo.py's `train_tests` holds the attention zoo's.

Every test file ends with `blocked_imports_test`: its models built and
predicted in a process that refuses jax, flax, yaml, cv2, PIL and the JAX
package.
"""

from functools import partial

import numpy as np
import pytest
import torch

from tests.test_torch_modules import randomize, to_nhwc
from tests.test_torch_train import leaves
from tests.torch_attn_zoo import STRIDES, jax_module
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, yaml_model_load
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

IMGSZ = 64
TOL = 1e-5
# the name given to YOLO(...): (its file under cfg/models, its head, its task)
YAMLS = {
    "yolov8n-att.yaml": ("v8/yolov8-att.yaml", "Detect", "detect"),
    "maf-yolov2n.yaml": ("maf/maf-yolov2.yaml", "v10Detect", "detect"),
    "maf-yolov2n-mafdetect.yaml": ("maf/maf-yolov2-mafdetect.yaml", "MAFDetect", "detect"),
    "maf-yolov2n-mafseg.yaml": ("maf/maf-yolov2-mafseg.yaml", "MAFSegment", "segment"),
    "maf-yolov2n-mafpose.yaml": ("maf/maf-yolov2-mafpose.yaml", "MAFPose", "pose"),
    "maf-yolov2n-mafobb.yaml": ("maf/maf-yolov2-mafobb.yaml", "MAFOBB", "obb"),
    "hyper-yolo-n.yaml": ("hyper/hyper-yolo.yaml", "Detect", "detect"),
    "hyper-yolo-n-seg.yaml": ("hyper/hyper-yolo-seg.yaml", "Segment", "segment"),
    "hyper-yolo-n-pose.yaml": ("hyper/hyper-yolo-pose.yaml", "Pose", "pose"),
}
NEAR = 1e-4  # a pair whose distance lies within this share of the threshold may flip between devices


def seeded(variables: dict) -> dict:
    """The tree with every bare `weight` kernel (DCNv2, DeformConvDW) redrawn
    by its fan-in, seeded by its shape."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "weight" and np.ndim(v) == 4:
                shape = np.shape(v)
                rng = np.random.default_rng(sum(shape))
                out[k] = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(t) for c, t in variables.items()}


def jax_variables(module, seed: int, x_shape=(1, IMGSZ, IMGSZ, 3), **init_kw) -> dict:
    """Seeded variables of a flax module (`randomize`, then `seeded`), their
    layout from `jax.eval_shape` of its init."""
    import jax

    shapes = jax.eval_shape(partial(module.init, **init_kw), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(x_shape, np.float32))
    return seeded(randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), seed))


def jax_and_port(name: str, seed: int):
    """(JAX flax module, its seeded variables, the port's task model at
    IMGSZ with them loaded strictly) of YAML name."""
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
    from ultralytics_pro_tpu_torch.nn import tasks

    jm = jax_module(jyaml(name))
    variables = jax_variables(jm, seed, train=True)
    d = yaml_model_load(name)
    with pytest.MonkeyPatch.context() as mp:  # the load replaces every value
        mp.setattr(tasks, "init_weights", lambda model, generator: None)
        port = model_class_for(guess_model_task(d))(d, imgsz=IMGSZ)
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, variables, port


def assert_round_trip(port, variables):
    back = dict(leaves(torch_state_dict_to_jax(port.state_dict())))
    assert back.keys() == dict(leaves(variables)).keys()  # every name both ways
    for k, w in leaves(variables):
        np.testing.assert_array_equal(back[k], w, err_msg="/".join(k))


def close(got, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def incidence_report(module, t: torch.Tensor) -> dict:
    """A HyperComputeModule's incidence on tokens t (B, N, C): its share of
    ones, the pairs within NEAR of the threshold, and the pairs whose
    membership differs from a float64 incidence outside those."""
    hg = module.incidence(t).bool()
    t64 = t.double()
    sq = (t64 * t64).sum(-1)
    d = (sq[:, :, None] + sq[:, None, :] - 2.0 * t64 @ t64.transpose(1, 2)).clamp(min=0).sqrt()
    near = (d - module.threshold).abs() <= NEAR * module.threshold
    return {"share": float(hg.double().mean()), "near_pairs": int(near.sum()),
            "differ_outside_near": int(((hg != (d < module.threshold)) & ~near).sum())}


def model_tests(names):
    """The whole-model test of each YAML of `names`."""

    @pytest.mark.parametrize("name", names)
    def test_model_forward_matches_jax(name, capsys):
        import jax

        from ultralytics_pro_tpu_torch.nn.modules.families import HyperComputeModule

        _, head, task = YAMLS[name]
        jm, variables, port = jax_and_port(name, seed=8)
        assert type(port.model[-1]).__name__ == head and port.task == guess_model_task(port.yaml) == task
        assert_round_trip(port, variables)
        assert port.stride.tolist() == list(STRIDES)
        x = np.random.default_rng(9).uniform(0, 1, (2, 3, IMGSZ, IMGSZ)).astype(np.float32)
        want, aux = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
        want = np.asarray(want)
        seen = {}

        def tokens(m, args):  # the hypergraph layer's input tokens (B, N, C)
            seen[m] = args[0].flatten(2).transpose(1, 2)

        hooks = [m.register_forward_pre_hook(tokens) for m in port.modules() if isinstance(m, HyperComputeModule)]
        with torch.no_grad():
            got, got_aux = port(torch.from_numpy(x))
        for h in hooks:
            h.remove()
        got, nc = got.numpy(), port.nc
        assert got.shape == want.shape
        np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
        if head == "v10Detect":  # (B, 300, 6) rows: xywh, conf, cls
            np.testing.assert_allclose(got[..., 4], want[..., 4], atol=TOL, rtol=0)
            np.testing.assert_array_equal(got[..., 5], want[..., 5])
        else:
            np.testing.assert_allclose(got[..., 4:4 + nc], want[..., 4:4 + nc], atol=TOL, rtol=0)
            if got.shape[-1] > 4 + nc:
                close(got[..., 4 + nc:], want[..., 4 + nc:])
        for key in ("feats", "one2one") if head == "v10Detect" else ("feats",):
            for g, w in zip(got_aux[key] if isinstance(got_aux, dict) else got_aux, aux[key], strict=True):
                close(to_nhwc(g), w)
        if isinstance(got_aux, dict) and "protos" in got_aux:
            close(to_nhwc(got_aux["protos"]), aux["protos"])
        for m, t in seen.items():
            report = incidence_report(m, t)
            with capsys.disabled():
                print(f"\n{name} hypergraph incidence on {tuple(t.shape)} tokens: {report}")
            assert report["differ_outside_near"] == 0, report

    return test_model_forward_matches_jax


def blocked_imports_test(names, train: str | None = None):
    """A test that builds each YAML of `names` and predicts one image at 64
    px (and, with `train`, one epoch of that YAML at 32 px on the detect
    fixture set) in a process refusing jax, flax, yaml, cv2, PIL and the JAX
    package."""
    import shutil
    import subprocess
    import sys

    from tests.test_torch_imports import BLOCKED, REPO, _blocker

    def test_models_run_with_jax_yaml_cv2_pil_blocked(tmp_path):
        then = ("import numpy as np, torch\n"
                "torch.set_num_threads(2)\n"
                "from ultralytics_pro_tpu_torch import YOLO\n"
                "img = np.zeros((48, 64, 3), np.uint8)\n"
                f"for name in {list(names)!r}:\n"
                "    m = YOLO(name, device='cpu')\n"
                "    r = m.predict([img], imgsz=64, conf=1e-6)[0]\n"
                "    assert (r.obb if m.task == 'obb' else r.boxes) is not None, name\n")
        if train:
            data = shutil.copytree(REPO / "tests" / "fixtures" / "torch_val_synth", tmp_path / "set")
            (data / "train.yaml").write_text("train: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
            then += (f"m = YOLO({train!r}, device='cpu')\n"
                     f"m.train(data={str(data / 'train.yaml')!r}, epochs=1, imgsz=32, batch=8, nbs=8, workers=2, "
                     f"max_gt=16, warmup_epochs=0.0, conf=1e-6, project={str(tmp_path / 'runs')!r})\n"
                     "assert m.trainer.last_fitness is not None\n")
        out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                             text=True, cwd=REPO, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]

    return test_models_run_with_jax_yaml_cv2_pil_blocked


# -- one trainer step against the JAX trainer -------------------------------------------------

TRAIN_NC = 3
DETECT_PARTS = ["box", "cls", "dfl"]
E2E_PARTS = [f"{a}_{p}" for a in ("o2m", "o2o") for p in DETECT_PARTS]


def subtree(tree: dict, path):
    """tree[path] for a key, tree[path[0]][path[1]]... for a tuple of keys."""
    for key in (path,) if isinstance(path, str) else path:
        tree = tree[key]
    return tree


def train_tests(cfg: str, imgsz: int, parts, layer):
    """The trainer test of YAML cfg at imgsz, as tests/torch_attn_zoo.py's
    `train_tests` holds the attention zoo's: both facades from the port's
    seed-3 weights at nc 3 (a model with MHSA layers bound at imgsz first),
    one epoch of the detect fixture set (16 images, train = val, batch 8,
    nbs 16: one optimizer step, no warmup), the port's loader on cv2's
    INTER_AREA and the JAX BN's two-pass variance on one device. Loss parts
    (`parts`) within 1e-3 relative; parameters, EMA and BN statistics within
    1e-4 of the tree's largest magnitude; momentum buffers within
    JAX_STEP_TOL; every parameter of the flax layer `layer` (the deformable
    block, RepHMS, the hypergraph conv; a tuple of keys names a module inside
    a layer) moved in both steps."""
    from tests.test_torch_rtdetr_train import JAX_STEP_TOL, rel_l2
    from tests.test_torch_train import same_images_as_jax, task_data_yaml
    from tests.test_torch_zoo_train import tree_max_rel
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    kw = dict(epochs=1, imgsz=imgsz, batch=8, nbs=16, warmup_epochs=0.0, val=False, workers=2, max_gt=32)

    @pytest.fixture(scope="module")
    def trained(tmp_path_factory):
        from ultralytics_pro_tpu import YOLO as JYOLO
        from ultralytics_pro_tpu.nn.modules import conv as jconv
        from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

        root = tmp_path_factory.mktemp("amh_train")
        data = task_data_yaml(root / "set")
        port = YOLO({**yaml_model_load(cfg), "nc": TRAIN_NC}, device="cpu", seed=3)
        port._bind_size(imgsz)  # MHSA's rel_h, rel_w at the step's map size, as the JAX facade initialises them
        jax_yolo = JYOLO({**jyaml(cfg), "nc": TRAIN_NC})
        jax_yolo.model.variables = start = torch_state_dict_to_jax(port.model.state_dict())
        with same_images_as_jax():
            port.train(data=str(data), project=str(root / "port"), **kw)
        saved = jconv.BN_FAST_VARIANCE[0]
        jconv.BN_FAST_VARIANCE[0] = False
        try:
            jax_yolo.train(data=str(data), project=str(root / "jax"), device=1, **kw)
        finally:
            jconv.BN_FAST_VARIANCE[0] = saved
        return port, jax_yolo, start

    def test_trainer_step_matches_jax(trained):
        port, jax_yolo, start = trained
        tp, tj = port.trainer, jax_yolo.trainer
        assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 1)
        (got,), (want,) = tp.loss_history, tj.loss_history
        assert list(got) == parts and set(want) == set(got)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), (k, got, want)
        cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
        for key in ("params", "ema", "batch_stats"):
            assert tree_max_rel(cp[key], cj[key]) <= 1e-4, key
        tree, (leaf, where) = rel_l2(cp["momentum_buffer"], cj["momentum_buffer"])
        assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)
        before = dict(leaves(subtree(start["params"], layer)))
        for ckpt in (cp, cj):
            after = dict(leaves(subtree(ckpt["params"], layer)))
            assert after.keys() == before.keys()
            assert all(np.abs(after[k] - w).max() > 0 for k, w in before.items()), \
                [k for k, w in before.items() if not np.abs(after[k] - w).max() > 0]

    return trained, test_trainer_step_matches_jax
