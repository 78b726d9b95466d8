"""YOLOv8, classify and RT-DETR modules in NCHW with the torch reference's names."""

from ultralytics_pro_tpu_torch.nn.modules.block import DFL, SPPF, Bottleneck, C2f, HGBlock, HGStem, Proto, RepC3
from ultralytics_pro_tpu_torch.nn.modules.conv import Concat, Conv, DWConv, LightConv, RepConv, autopad
from ultralytics_pro_tpu_torch.nn.modules.head import (
    OBB,
    Classify,
    Detect,
    Pose,
    RTDETRDecoder,
    Segment,
    decode_single_label,
)
from ultralytics_pro_tpu_torch.nn.modules.transformer import (
    AIFI,
    MLP,
    DeformableTransformerDecoderLayer,
    MSDeformAttn,
    MultiheadAttention,
    TransformerEncoderLayer,
)

__all__ = ["AIFI", "C2f", "Bottleneck", "Classify", "Concat", "Conv", "DFL", "DWConv",
           "DeformableTransformerDecoderLayer", "Detect", "HGBlock", "HGStem", "LightConv", "MLP",
           "MSDeformAttn", "MultiheadAttention", "OBB", "Pose", "Proto", "RTDETRDecoder", "RepC3", "RepConv",
           "SPPF", "Segment",
           "TransformerEncoderLayer", "autopad", "decode_single_label"]
