"""The blocks and whole backbones of ConvNeXt, Swin, PVTv2, EfficientViT,
FasterNet, RepViT, StarNet, LSKNet, MobileNetV4 and EfficientNetV2 against
their JAX flax modules, on the CPU, in eval and train mode
(tests/torch_yolo11_bb.py's `module_tests`). The backbones are narrowed
(depths of 1-2, widths of 8-96); Swin runs at 72 px, so its stages pad
every map to the window and merge odd maps (9 -> 5 -> 3), and its blocks
alone run shifted and unshifted on a 9 x 11 map."""

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.torch_yolo11_bb import module_tests
from ultralytics_pro_tpu.nn.modules import backbones as JB
from ultralytics_pro_tpu.nn.modules import backbones2 as JB2
from ultralytics_pro_tpu_torch.nn.modules import backbones as PB
from ultralytics_pro_tpu_torch.nn.modules import backbones2 as PB2

IMG = (2, 3, 64, 64)
CASES = {
    "convnext_block": (lambda: JB.ConvNeXtBlock(dim=16), lambda: PB.ConvNeXtBlock(16), (2, 16, 9, 9), "nchw"),
    "convnext": (lambda: JB.ConvNeXt(depths=(1, 1, 2, 1), dims=(16, 24, 32, 40)),
                 lambda: PB.ConvNeXt(3, (1, 1, 2, 1), (16, 24, 32, 40)), IMG, "nchw"),
    "swin_block_shift_pad": (lambda: JB.SwinBlock(dim=24, heads=3, shift=3), lambda: PB.SwinBlock(24, 3, 7, 3),
                             (2, 24, 9, 11), "nhwc"),
    "swin_block_pad": (lambda: JB.SwinBlock(dim=24, heads=3), lambda: PB.SwinBlock(24, 3, 7, 0), (2, 24, 9, 11),
                       "nhwc"),
    "swin": (lambda: JB.SwinTransformer(depths=(2, 2, 2, 2), dims=(24, 48, 72, 96), heads=(3, 3, 3, 3)),
             lambda: PB.SwinTransformer(3, (2, 2, 2, 2), (24, 48, 72, 96), (3, 3, 3, 3)), (2, 3, 72, 72), "nchw"),
    "pvt_block": (lambda: JB.PVT2Block(dim=32, heads=2, sr=2, mlp_ratio=2.0), lambda: PB.PVT2Block(32, 2, 2, 2.0),
                  (2, 32, 6, 6), "nhwc"),
    "pvtv2": (lambda: JB.PVTv2(dims=(16, 32, 48, 64), depths=(1, 1, 1, 1), heads=(1, 2, 3, 4)),
              lambda: PB.PVTv2(3, (16, 32, 48, 64), (1, 1, 1, 1), (1, 2, 3, 4)), IMG, "nchw"),
    "lite_mla": (lambda: JB.LiteMLA(dim=32), lambda: PB.LiteMLA(32), (2, 32, 5, 7), "nchw"),
    "efficientvit": (lambda: JB.EfficientViT(dims=(16, 32, 32, 48), depths=(1, 1, 2, 1)),
                     lambda: PB.EfficientViT(3, (16, 32, 32, 48), (1, 1, 2, 1)), IMG, "nchw"),
    "fasternet": (lambda: JB2.FasterNet(depths=(1, 1, 2, 1), dims=(16, 24, 32, 40)),
                  lambda: PB2.FasterNet(3, (1, 1, 2, 1), (16, 24, 32, 40)), IMG, "nchw"),
    "repvit": (lambda: JB2.RepViT(depths=(2, 1, 2, 1), dims=(16, 24, 32, 40)),
               lambda: PB2.RepViT(3, (2, 1, 2, 1), (16, 24, 32, 40)), IMG, "nchw"),
    "starnet": (lambda: JB2.StarNet(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32)),
                lambda: PB2.StarNet(3, (1, 1, 1, 1), (8, 16, 24, 32)), IMG, "nchw"),
    "lsknet": (lambda: JB2.LSKNet(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32)),
               lambda: PB2.LSKNet(3, (1, 1, 1, 1), (8, 16, 24, 32)), IMG, "nchw"),
    "mobilenetv4": (lambda: JB2.MobileNetV4(dims=(8, 16, 24, 32), depths=(1, 2, 2, 1)),
                    lambda: PB2.MobileNetV4(3, (8, 16, 24, 32), (1, 2, 2, 1)), IMG, "nchw"),
    "efficientnetv2": (lambda: JB2.EfficientNetV2(dims=(8, 16, 24, 32), depths=(1, 1, 2, 2)),
                       lambda: PB2.EfficientNetV2(3, (8, 16, 24, 32), (1, 1, 2, 2)), IMG, "nchw"),
}

test_module_matches_jax = module_tests(CASES)
