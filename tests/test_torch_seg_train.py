"""The port's segment training against the JAX trainer, on the CPU.

Both packages start from the reference-trained yolov8n-seg of
`val_parity_segment_model.npz` (nc 3) and train with the same arguments on
a copy of `tests/fixtures/torch_val_synth_segment/` (train = val): `YOLO(...).train(data=...,
epochs=2, imgsz=64, batch=2, nbs=8, ...)`, as tests/test_torch_train.py does
for detect, whose helpers and tolerances these are: per-epoch losses within
1e-4 relative; parameters, EMA and BN statistics within 1e-4 and momentum
buffers within 2e-3 of each tensor's largest magnitude; a checkpoint of
either package predicts the same in both. Both loaders shrink the images
with cv2 here (`same_images_as_jax`), so both packages see the same pixels. The batches carry the
collate's GT masks (overlaps resolved, rows largest first).
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

TASK = "segment"


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return task_data_yaml(tmp_path_factory.mktemp("seg_train") / "set", TASK)


@pytest.fixture(scope="module")
def trained(data_yaml, tmp_path_factory):
    with same_images_as_jax():
        return train_both(data_yaml, tmp_path_factory.mktemp("seg_runs"), TASK, **TRAIN_KW)


def test_seg_train_matches_jax_step_for_step(trained):
    """batch 2, nbs 8 -> accumulate 4; no warmup; 16 images -> 8 micro-batches an epoch."""
    port, jax_yolo = trained
    assert type(port.trainer).__name__ == "SegmentationTrainer"
    assert port.trainer.accumulate == 4 and port.trainer.opt_steps == 4
    cp, cj = assert_same_training(port, jax_yolo)
    assert sorted(cp) == sorted(cj) and cp["epoch"] == cj["epoch"] == 1
    assert cp["model_yaml"]["nc"] == 3
    assert set(port.trainer.loss_history[0]) == {"box", "seg", "cls", "dfl"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_seg_checkpoint_predicts_the_same_in_both_packages(trained, writer):
    port, jax_yolo = trained
    assert_checkpoint_predicts_the_same((port if writer == "port" else jax_yolo).trainer.wdir / "last.ckpt")
