"""The RTMDet, YOLOv7, YOLOv4-CSP and YOLOR-CSP models in a process that
refuses jax, flax, yaml, cv2, PIL and the JAX package (the card's machine
has none of them), on the CPU: the port's reader reads the eleven YAMLs as
written (PyYAML's block dumps among them) equal to `yaml.safe_load` of the
JAX package's files, each narrowed model (rtmdet at scale t) predicts at
64 px, and a narrowed yolov7-anchor trains an epoch and loads what it
wrote."""

import json
import shutil
import subprocess
import sys

from tests.test_torch_imports import BLOCKED, REPO, _blocker
from tests.torch_csp_zoo import NARROW, YAMLS


def test_csp_zoo_reads_predicts_and_trains_with_jax_yaml_cv2_pil_blocked(tmp_path):
    import yaml

    data = shutil.copytree(REPO / "tests" / "fixtures" / "torch_val_synth", tmp_path / "set")
    (data / "train.yaml").write_text("train: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    read = tmp_path / "read.json"
    then = ("import json, numpy as np, torch\n"
            "torch.set_num_threads(2)\n"
            "from ultralytics_pro_tpu_torch import YOLO\n"
            "from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load\n"
            "from ultralytics_pro_tpu_torch.utils import PKG_ROOT, miniyaml\n"
            f"yamls = {json.dumps({k: v[0] for k, v in YAMLS.items()})}\n"
            f"narrow = {NARROW!r}\n"
            "read = {}\n"
            "img = np.zeros((48, 64, 3), np.uint8)\n"
            "for name, rel in yamls.items():\n"
            "    read[rel] = miniyaml.load(PKG_ROOT / 'cfg' / 'models' / rel)\n"
            "    d = yaml_model_load(name)\n"
            "    m = YOLO(d if d.get('scales') else {**d, **narrow}, device='cpu')\n"
            "    r = m.predict([img], imgsz=64, conf=1e-6)[0]\n"
            "    assert (r.obb if m.task == 'obb' else r.boxes) is not None, name\n"
            f"json.dump(read, open({str(read)!r}, 'w'))\n"
            "m = YOLO({**yaml_model_load('yolov7-anchor.yaml'), **narrow}, device='cpu')\n"
            f"m.train(data={str(data / 'train.yaml')!r}, epochs=1, imgsz=32, batch=8, nbs=8, workers=2, "
            f"max_gt=16, warmup_epochs=0.0, conf=1e-6, project={str(tmp_path / 'runs')!r})\n"
            "assert m.trainer.last_fitness is not None\n"
            "YOLO(str(m.trainer.wdir / 'last.ckpt'), device='cpu')")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(read.read_text())
    jax_models = REPO / "ultralytics_pro_tpu" / "cfg" / "models"
    assert len(got) == 11
    for rel, d in got.items():
        assert d == json.loads(json.dumps(yaml.safe_load((jax_models / rel).read_text()))), rel
