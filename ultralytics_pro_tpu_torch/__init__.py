"""ultralytics_pro_tpu_torch: the PyTorch/CUDA port of ultralytics_pro_tpu.

Imports torch and numpy only: nothing of JAX, of the JAX package, of PyYAML
or of OpenCV. Entry points run on the card unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"

from ultralytics_pro_tpu_torch.engine.model import YOLO, Model  # noqa: E402
from ultralytics_pro_tpu_torch.models.rtdetr import RTDETR  # noqa: E402

__all__ = ["YOLO", "Model", "RTDETR", "__version__"]
