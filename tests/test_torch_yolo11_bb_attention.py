"""GhostNetV2, EfficientFormerV2, Bi_FPN and the slim neck's blocks against
their JAX flax modules, on the CPU, in eval and train mode
(tests/torch_yolo11_bb.py's `module_tests`), and EfficientFormerV2's offset
table against the JAX loop.

- GhostNetV2's DFC-gated ghost module runs on a 5 x 5 map, where its 2 x 2
  gate is resized to 5 x 5: `jax.image.resize`'s "nearest" samples at the
  half pixel, as torch's "nearest-exact" does, where torch's "nearest"
  takes other rows and columns. The whole backbone (width 0.5) runs at
  96 px: at 64 px its last map is 2 x 2, and train-mode BatchNorm over the
  8 values of a channel there leaves both frameworks' f32 outputs 1.3e-5
  (the port) and 2.0e-5 (JAX) of the largest value from a float64 forward,
  2.4e-5 apart; at 96 px they are 3.0e-6 and 5.9e-6 from it.
- Attention4D, with and without its stride, and Attention4DDownsample run
  at two grid sizes, 5 x 7 and an even one.
"""

import math

import numpy as np
import pytest

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_yolo11_bb import bound, bound_at, module_tests
from ultralytics_pro_tpu.nn.modules import backbones5 as JB5
from ultralytics_pro_tpu.nn.modules import efficientformer as JE
from ultralytics_pro_tpu.nn.modules import necks as JN
from ultralytics_pro_tpu_torch.nn.modules import backbones5 as PB5
from ultralytics_pro_tpu_torch.nn.modules import efficientformer as PE
from ultralytics_pro_tpu_torch.nn.modules import necks as PN


def attention(stride: int, h: int, w: int):
    return (lambda: JE.Attention4D(dim=16, key_dim=8, num_heads=4, attn_ratio=2, stride=stride),
            lambda: bound(PE.Attention4D(16, 8, 4, 2, stride), h, w), (2, 16, h, w), "nchw")


def downsample(h: int, w: int):
    return (lambda: JE.Attention4DDownsample(dim=16, out_dim=24, key_dim=8, num_heads=4, attn_ratio=2),
            lambda: bound(PE.Attention4DDownsample(16, 24, 8, 4, 2), h, w), (2, 16, h, w), "nchw")


CASES = {
    "ghost_module_dfc_5x5": (lambda: JB5._GhostModuleV2(oup=16, attn=True),
                             lambda: PB5._GhostModuleV2(8, 16, attn=True), (2, 8, 5, 5), "nchw"),
    "ghost_bottleneck_se_stride": (lambda: JB5._GhostBottleneckV2(mid=24, out=16, k=5, stride=2, se_ratio=0.25,
                                                                  attn=True),
                                   lambda: PB5._GhostBottleneckV2(8, 24, 16, 5, 2, 0.25, attn=True), (2, 8, 9, 9),
                                   "nchw"),
    "ghostnetv2": (lambda: JB5.GhostNetV2Backbone(width=0.5), lambda: PB5.GhostNetV2Backbone(3, 0.5),
                   (2, 3, 96, 96), "nchw"),
    "attention4d_5x7": attention(0, 5, 7),
    "attention4d_4x4": attention(0, 4, 4),
    "attention4d_stride_5x7": attention(2, 5, 7),
    "attention4d_stride_6x6": attention(2, 6, 6),
    "attention4d_downsample_5x7": downsample(5, 7),
    "attention4d_downsample_6x6": downsample(6, 6),
    "efficientformerv2": (lambda: JE.EfficientFormerV2(), lambda: bound_at(PE.EfficientFormerV2(3), (1, 3, 64, 64)),
                          (2, 3, 64, 64), "nchw"),
    "bi_fpn_2": (lambda: JN.Bi_FPN(), lambda: PN.Bi_FPN(2), (2, 8, 5, 5), 2),
    "bi_fpn_3": (lambda: JN.Bi_FPN(), lambda: PN.Bi_FPN(3), (2, 8, 5, 5), 3),
    "gsconv": (lambda: JN.GSConv(c2=16, k=3, s=2), lambda: PN.GSConv(8, 16, 3, 2), (2, 8, 9, 9), "nchw"),
    "gsbottleneck": (lambda: JN.GSBottleneck(c2=16), lambda: PN.GSBottleneck(8, 16), (2, 8, 9, 9), "nchw"),
    "vovgscsp": (lambda: JN.VoVGSCSP(c2=32, n=2), lambda: PN.VoVGSCSP(16, 32, 2), (2, 16, 9, 9), "nchw"),
}

test_module_matches_jax = module_tests(CASES)


@pytest.mark.parametrize("hq,wq,h,w", [(4, 5, 4, 5), (3, 4, 5, 7), (2, 2, 3, 3), (10, 10, 20, 20), (7, 7, 7, 7)])
def test_offset_table_equals_the_jax_loop(hq, wq, h, w):
    """`rpe_table` (vectorised) numbers the offsets as the JAX `_rpe_table`
    double loop does, the key grid's scale h / hq where it is coarser."""
    import itertools

    pts_q = list(itertools.product(range(hq), range(wq)))
    pts_k = list(itertools.product(range(h), range(w)))
    want, n = JE._rpe_table(pts_q, pts_k, scale_y=h / hq, scale_x=w / wq)
    got, m = PE.rpe_table(hq, wq, h, w, h / hq, w / wq)
    assert m == n
    np.testing.assert_array_equal(got, want)


def test_bound_grids_follow_the_strided_convs():
    """The grid an Attention4D (stride 2) and an Attention4DDownsample bind
    to is the one their strided convs give: ceil(h / 2) x ceil(w / 2), and
    `attention_biases` has one column per offset (h x w for Attention4D)."""
    for h, w in ((5, 7), (6, 6), (20, 20)):
        a = bound(PE.Attention4D(16, 8, 4, 2, 2), h, w)
        assert a.attention_biases.shape == (4, math.ceil(h / 2) * math.ceil(w / 2))
        d = bound(PE.Attention4DDownsample(16, 24, 8, 4, 2), h, w)
        _, n = PE.rpe_table(math.ceil(h / 2), math.ceil(w / 2), h, w, h / math.ceil(h / 2), w / math.ceil(w / 2))
        assert d.attention_biases.shape == (4, n) and d.bias_idx.shape == (math.ceil(h / 2) * math.ceil(w / 2), h * w)
        with pytest.raises(ValueError, match="attention_biases"):
            a.eval()(__import__("torch").zeros(1, 16, h + 1, w))
