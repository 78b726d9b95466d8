"""The port's pose training against the JAX trainer, on the CPU.

Both packages start from the reference-trained yolov8n-pose of
`val_parity_pose_model.npz` (nc 3, `kpt_shape` [5, 3]) and train with the same arguments on
a copy of `tests/fixtures/torch_val_synth_pose/` (train = val): `YOLO(...).train(data=...,
epochs=2, imgsz=64, batch=2, nbs=8, ...)`, as tests/test_torch_train.py does
for detect, whose helpers and tolerances these are: per-epoch losses within
1e-4 relative; parameters, EMA and BN statistics within 1e-4 and momentum
buffers within 2e-3 of each tensor's largest magnitude; a checkpoint of
either package predicts the same in both. Both loaders shrink the images
with cv2 here (`same_images_as_jax`), so both packages see the same pixels. The set's `kpt_shape` is [5, 3], so the
criteria take the 1/K sigmas (the 17x3 OKS sigmas are covered in
tests/test_torch_task_loss.py).
"""

import pytest

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import (
    TRAIN_KW,
    assert_checkpoint_predicts_the_same,
    assert_same_training,
    same_images_as_jax,
    task_data_yaml,
    train_both,
)
from ultralytics_pro_tpu_torch import YOLO

TASK = "pose"


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return task_data_yaml(tmp_path_factory.mktemp("pose_train") / "set", TASK)


@pytest.fixture(scope="module")
def trained(data_yaml, tmp_path_factory):
    with same_images_as_jax():
        return train_both(data_yaml, tmp_path_factory.mktemp("pose_runs"), TASK, **TRAIN_KW)


def test_pose_train_matches_jax_step_for_step(trained):
    """batch 2, nbs 8 -> accumulate 4; no warmup; 16 images -> 8 micro-batches an epoch."""
    port, jax_yolo = trained
    assert type(port.trainer).__name__ == "PoseTrainer"
    assert port.trainer.accumulate == 4 and port.trainer.opt_steps == 4
    cp, cj = assert_same_training(port, jax_yolo)
    assert sorted(cp) == sorted(cj) and cp["epoch"] == cj["epoch"] == 1
    assert cp["model_yaml"]["nc"] == 3
    assert port.model.model[-1].kpt_shape == (5, 3) and port.trainer.criterion.kpt_shape == (5, 3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pose_checkpoint_predicts_the_same_in_both_packages(trained, writer):
    port, jax_yolo = trained
    assert_checkpoint_predicts_the_same((port if writer == "port" else jax_yolo).trainer.wdir / "last.ckpt")


def test_pose_model_is_rebuilt_at_the_dataset_kpt_shape(data_yaml, tmp_path):
    """yolov8n-pose.yaml (80 classes, 17x3) trained on the [5, 3] set is
    rebuilt at nc 3 and [5, 3]; its checkpoint's model YAML names that
    shape in the Pose row, so either package builds a [5, 3] head from it.
    A model whose head already has the set's shape keeps its weights (the
    step-for-step test starts from the trained ones)."""
    model = YOLO("yolov8n-pose.yaml", device="cpu")
    assert model.model.model[-1].kpt_shape == (17, 3)
    model.train(data=str(data_yaml), project=str(tmp_path), **{**TRAIN_KW, "epochs": 1})
    assert model.model.nc == 3 and model.model.model[-1].kpt_shape == (5, 3)
    assert model.model.yaml["head"][-1][2:] == ["Pose", ["nc", [5, 3]]]
    port, jax_yolo = assert_checkpoint_predicts_the_same(model.trainer.wdir / "last.ckpt", conf=1e-6)
    assert port.model.model[-1].kpt_shape == (5, 3)
    assert dict(jax_yolo.model._head_spec().kwargs)["kpt_shape"] == (5, 3)
