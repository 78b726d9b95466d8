"""Import hygiene of the port: the card's machine has no JAX, PyYAML, OpenCV or PIL.

In a subprocess whose `sys.meta_path` refuses jax, flax, yaml, cv2 and
ultralytics_pro_tpu, every module of ultralytics_pro_tpu_torch and
chip_smoke.py must import, a short training run goes through (with
classify predict, val and training and a narrow RT-DETR's val), segment val
(polygon fill and mask shrink included) and pose predict run, and obb val
(minAreaRect, the rotated NMS, probiou matching) and predict run; with PIL
refused as well, they import and `imread` still reads a PNG, equal to cv2's
reading. An AST scan of the same
files must find no import of the first names.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ultralytics_pro_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "ultralytics_pro_tpu")


def _blocker(blocked, then: str = "") -> str:
    """A script that refuses `blocked`, imports every module of the port and
    chip_smoke.py, checks that none of `blocked` was loaded, runs `then` and
    prints the number of modules."""
    return f"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = {blocked!r}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Blocker())
sys.path.insert(0, {str(REPO)!r})
import ultralytics_pro_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, "ultralytics_pro_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(REPO / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
{then}
leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


BLOCKER = _blocker(BLOCKED)


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_with_jax_yaml_cv2_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKER], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.strip().splitlines()[-1])
    assert n == len(list(PORT.rglob("*.py"))) - 1  # every module but the package __init__


def test_port_imports_and_reads_png_with_pil_blocked_too(tmp_path):
    import cv2
    import numpy as np

    png = REPO / "tests" / "fixtures" / "torch_val_synth" / "images" / "val" / "val3.png"
    then = ("from ultralytics_pro_tpu_torch.data.image_io import imread\n"
            f"import numpy; numpy.save({str(tmp_path / 'read.npy')!r}, imread({str(png)!r}))")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) == len(list(PORT.rglob("*.py"))) - 1
    np.testing.assert_array_equal(np.load(tmp_path / "read.npy"), cv2.imread(str(png)))


def test_port_trains_with_jax_yaml_cv2_blocked(tmp_path):
    """The train path (dataset, loader, model, TAL, loss, SGD, EMA, epoch-end
    val on K1's plain version, checkpoint) runs in the blocking process and
    loads what it wrote; so do classify predict, val and one train epoch on
    the classify fixture set (its PNG class folders), and the narrow
    RT-DETR's val on the detect set (K2's plain version)."""
    import shutil

    from tests.test_torch_rtdetr import NARROW

    data = shutil.copytree(REPO / "tests" / "fixtures" / "torch_val_synth", tmp_path / "set")
    cls_set = REPO / "tests" / "fixtures" / "torch_cls_synth"
    (data / "train.yaml").write_text("train: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    then = ("from ultralytics_pro_tpu_torch import YOLO\n"
            "m = YOLO('yolov8n.yaml', device='cpu')\n"
            f"m.train(data={str(data / 'train.yaml')!r}, epochs=1, imgsz=32, batch=8, nbs=8, workers=2, "
            f"max_gt=16, warmup_epochs=0.0, project={str(tmp_path / 'runs')!r})\n"
            "assert m.trainer.last_fitness is not None\n"
            "YOLO(str(m.trainer.wdir / 'last.ckpt'), device='cpu')\n"
            "import numpy as np\n"
            "from ultralytics_pro_tpu_torch import RTDETR\n"
            "c = YOLO('yolov8n-cls.yaml', device='cpu')\n"
            "assert c.predict([np.zeros((40, 48, 3), np.uint8)], imgsz=32)[0].probs.data.shape == (1000,)\n"
            f"assert 0 <= c.val(data={str(cls_set)!r}, imgsz=32, batch=16).top1 <= 1\n"
            f"c.train(data={str(cls_set)!r}, epochs=1, imgsz=32, batch=8, nbs=8, workers=2, warmup_epochs=0.0, "
            f"project={str(tmp_path / 'cls_runs')!r})\n"
            "assert c.model.nc == 3 and c.trainer.last_fitness is not None\n"
            "YOLO(str(c.trainer.wdir / 'last.ckpt'), device='cpu')\n"
            f"r = RTDETR({NARROW!r}, device='cpu').val(data={str(data / 'data.yaml')!r}, imgsz=64, batch=16)\n"
            "assert len(r.stats['conf']) == 16")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED, then)], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_port_trains_rtdetr_with_jax_yaml_cv2_blocked(tmp_path):
    """RT-DETR training (the denoising queries, the DETR loss with its scipy
    matcher, K2's plain version under autograd, the checkpoint) runs in the
    blocking process, with PIL refused too, and loads what it wrote."""
    import shutil

    from tests.test_torch_rtdetr import NARROW

    data = shutil.copytree(REPO / "tests" / "fixtures" / "torch_val_synth", tmp_path / "set")
    (data / "train.yaml").write_text("train: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    then = ("import torch\n"
            "torch.set_num_threads(2)\n"
            "from ultralytics_pro_tpu_torch import RTDETR\n"
            f"m = RTDETR({NARROW!r}, device='cpu')\n"
            f"m.train(data={str(data / 'train.yaml')!r}, epochs=1, imgsz=64, batch=4, nbs=4, workers=2, "
            f"max_gt=4, num_dn=8, warmup_epochs=0.0, project={str(tmp_path / 'runs')!r})\n"
            "assert list(m.trainer.loss_history[0])[3:] == ['dn_cls', 'dn_bbox', 'dn_giou']\n"
            "RTDETR(str(m.trainer.wdir / 'last.ckpt'), device='cpu')")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_port_trains_the_tasks_with_jax_yaml_cv2_blocked(tmp_path, task):
    """Segment, pose and OBB training (the task's collate, criterion and
    assigner, the pose head rebuilt at the set's [5, 3], the epoch-end val)
    run in the blocking process, with PIL refused too, and load what they
    wrote."""
    import shutil

    data = shutil.copytree(REPO / "tests" / "fixtures" / f"torch_val_synth_{task}", tmp_path / "set")
    kpt = "kpt_shape: [5, 3]\n" if task == "pose" else ""
    (data / "train.yaml").write_text("train: images/val\nval: images/val\n" + kpt + "names:\n  0: a\n  1: b\n  2: c\n")
    yaml = {"segment": "yolov8n-seg.yaml", "pose": "yolov8n-pose.yaml", "obb": "yolov8n-obb.yaml"}[task]
    then = ("import torch\n"
            "torch.set_num_threads(2)\n"
            "from ultralytics_pro_tpu_torch import YOLO\n"
            f"m = YOLO({yaml!r}, device='cpu')\n"
            f"m.train(data={str(data / 'train.yaml')!r}, epochs=1, imgsz=32, batch=8, nbs=8, workers=2, "
            f"max_gt=16, warmup_epochs=0.0, conf=1e-6, project={str(tmp_path / 'runs')!r})\n"
            "assert m.trainer.last_fitness is not None\n"
            "YOLO(str(m.trainer.wdir / 'last.ckpt'), device='cpu')")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_port_serves_segment_and_pose_with_jax_yaml_cv2_blocked(tmp_path):
    """Segment val on its fixture set (labels, letterbox, the collate's
    polygon fill and shrink, masks on the model's device, mask IoU) and pose
    predict run in the blocking process, with PIL refused too."""
    import shutil

    data = shutil.copytree(REPO / "tests" / "fixtures" / "torch_val_synth_segment", tmp_path / "seg")
    then = ("import numpy as np\n"
            "from ultralytics_pro_tpu_torch import YOLO\n"
            "import ultralytics_pro_tpu_torch.data.rasterize, ultralytics_pro_tpu_torch.ops.masks\n"
            f"m = YOLO('yolov8n-seg.yaml', device='cpu').val(data={str(data / 'data.yaml')!r}, imgsz=64, batch=8)\n"
            "assert m.seg.map50 >= 0\n"
            "img = np.zeros((48, 64, 3), np.uint8)\n"
            "r = YOLO('yolov8n-pose.yaml', device='cpu').predict([img], imgsz=64, conf=1e-6)[0]\n"
            "assert r.keypoints.data.shape[1:] == (17, 3)")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_port_serves_obb_with_jax_yaml_cv2_blocked(tmp_path):
    """OBB val on its fixture set (labels through min_area_rect, the rotated
    letterbox and collate, the rotated NMS, probiou matching, DOTA files) and
    predict run in the blocking process, with PIL refused too."""
    import shutil

    data = shutil.copytree(REPO / "tests" / "fixtures" / "torch_val_synth_obb", tmp_path / "obb")
    then = ("import numpy as np\n"
            "from ultralytics_pro_tpu_torch import YOLO\n"
            "import ultralytics_pro_tpu_torch.data.geometry\n"
            f"m = YOLO('yolov8n-obb.yaml', device='cpu').val(data={str(data / 'data.yaml')!r}, imgsz=64, batch=8, "
            f"conf=1e-6, save_json=True, save_dir={str(tmp_path)!r})\n"
            "assert m.box.map50 >= 0\n"
            "img = np.zeros((48, 64, 3), np.uint8)\n"
            "r = YOLO('yolov8n-obb.yaml', device='cpu').predict([img], imgsz=64, conf=1e-6)[0]\n"
            "assert r.obb.xyxyxyxy.shape[1:] == (4, 2)")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(list((tmp_path / "predictions_dota").glob("Task1_*.txt"))) > 0


def test_no_blocked_import_in_sources():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in BLOCKED]
    assert not bad, bad


def test_no_binary_or_build_output_in_package():
    """Source only: nothing built is kept beside the sources."""
    suffixes = {".so", ".o", ".a", ".npz", ".pt", ".pkl", ".cubin", ".fatbin"}
    found = [p for p in PORT.rglob("*") if p.suffix in suffixes and "_build" not in p.parts]
    assert not found, found
