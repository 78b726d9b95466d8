"""Make the classify fixtures of the port's tests and of chip_smoke.py.

    JAX_PLATFORMS=cpu python tests/fixtures/make_cls_fixture.py

writes, under tests/fixtures/:
- torch_cls_synth/: PNG class folders class0-class2, 8 train images a class
  and 16 val images (6, 5, 5), each 80 wide and 64 high, drawn as the JAX
  package's `data/utils.py:_make_synth_cls` draws them (a filled circle,
  rectangle or thick line on a grey background of the class's level, in a
  seeded colour), so that at imgsz 64 the short-side resize is the identity
  and the centre crop cuts 8 columns a side;
- val_parity_cls_model.npz: yolov8n-cls at nc 3 trained by the JAX trainer
  at 64 px from its seeded initialisation (CLS_TRAIN below), its EMA
  parameters and BN statistics as the port's state_dict under `sd::` keys;
- val_parity_cls_ref.json: the JAX validator's top1 and top5 on those
  weights at batch 16, with the arguments of both runs.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures"
SET = FIXTURES / "torch_cls_synth"
NC, W, H = 3, 80, 64
SPLITS = {"train": (8, 8, 8), "val": (6, 5, 5)}
CLS_TRAIN = dict(epochs=40, imgsz=64, batch=8, nbs=8, warmup_epochs=0.0, workers=2, device=1)
CLS_VAL = dict(imgsz=64, batch=16)


def draw_set(root: Path) -> None:
    import cv2

    rng = np.random.default_rng(0)
    for split, counts in SPLITS.items():
        for c, n in enumerate(counts):
            d = root / split / f"class{c}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                im = np.full((H, W, 3), 30 * c + 40, np.uint8)
                color = tuple(int(v) for v in rng.integers(64, 255, 3))
                if c == 0:
                    cv2.circle(im, (W // 2, H // 2), H // 4 + i, color, -1)
                elif c == 1:
                    cv2.rectangle(im, (8 + i, 8), (W - 8, H - 8 - i), color, -1)
                else:
                    cv2.line(im, (0, i * 4), (W, H - i * 4), color, 5)
                cv2.imwrite(str(d / f"{split}_{c}_{i}.png"), im)


def main() -> None:
    sys.path.insert(0, str(REPO))
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.engine.trainer import load_pickle
    from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

    shutil.rmtree(SET, ignore_errors=True)
    draw_set(SET)
    with tempfile.TemporaryDirectory() as tmp:
        model = JYOLO("yolov8n-cls.yaml")
        model.train(data=str(SET), project=tmp, **CLS_TRAIN)
        ckpt_path = model.trainer.wdir / "last.ckpt"
        ckpt = load_pickle(ckpt_path)
        sd = jax_to_torch_state_dict({"params": ckpt["ema"], "batch_stats": ckpt["batch_stats"]})
        np.savez_compressed(FIXTURES / "val_parity_cls_model.npz",
                            **{f"sd::{k}": v.numpy() for k, v in sd.items()})
        m = JYOLO(str(ckpt_path)).val(data=str(SET), **CLS_VAL)
    ref = {"model": "yolov8n-cls.yaml", "nc": NC, "train_args": {k: v for k, v in CLS_TRAIN.items() if k != "device"},
           "val_args": CLS_VAL, "results": {"top1": m.top1, "top5": m.top5}}
    (FIXTURES / "val_parity_cls_ref.json").write_text(json.dumps(ref, indent=1) + "\n")
    print(ref)


if __name__ == "__main__":
    main()
