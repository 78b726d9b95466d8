"""YOLOv8, YOLO11, YOLOv10, YOLOv5, YOLOv9, YOLO12, YOLOv13, classify and RT-DETR modules in NCHW with the torch
reference's names (YOLOv13's hypergraph block under the JAX package's)."""

from ultralytics_pro_tpu_torch.nn.modules.block import (
    C3,
    CIB,
    DFL,
    PSA,
    SPP,
    SPPF,
    Attention,
    Bottleneck,
    C2f,
    C2fCIB,
    C2PSA,
    C3k,
    C3k2,
    HGBlock,
    HGStem,
    Proto,
    PSABlock,
    RepC3,
    SCDown,
)
from ultralytics_pro_tpu_torch.nn.modules.conv import Concat, Conv, DWConv, LightConv, RepConv, autopad
from ultralytics_pro_tpu_torch.nn.modules.head import (
    OBB,
    V5_ANCHORS,
    AnchorDetect,
    Classify,
    DDetect,
    Detect,
    DSegment,
    Pose,
    RTDETRDecoder,
    Segment,
    decode_single_label,
    v10Detect,
)
from ultralytics_pro_tpu_torch.nn.modules.transformer import (
    AIFI,
    MLP,
    DeformableTransformerDecoderLayer,
    MSDeformAttn,
    MultiheadAttention,
    TransformerEncoderLayer,
)
from ultralytics_pro_tpu_torch.nn.modules.v13 import (
    C3AH,
    DSC3k,
    DSC3k2,
    AdaHGComputation,
    DownsampleConv,
    DSBottleneck,
    DSConv,
    FullPAD_Tunnel,
    HyperACE,
)
from ultralytics_pro_tpu_torch.nn.modules.v9v12 import (
    SPPELAN,
    A2C2f,
    AAttn,
    ABlock,
    ADown,
    RepNBottleneck,
    RepNCSP,
    RepNCSPELAN4,
)

__all__ = ["AIFI", "A2C2f", "AAttn", "ABlock", "ADown", "AdaHGComputation", "AnchorDetect", "C3AH", "DSBottleneck",
           "DSC3k", "DSC3k2", "DSConv", "DownsampleConv", "FullPAD_Tunnel", "HyperACE",
           "Attention", "C2PSA", "C2f", "C2fCIB", "C3",
           "C3k", "C3k2", "CIB", "Bottleneck", "Classify", "Concat", "Conv", "DDetect", "DFL", "DSegment", "DWConv",
           "PSA", "PSABlock", "RepNBottleneck", "RepNCSP", "RepNCSPELAN4", "SCDown", "SPP", "SPPELAN", "V5_ANCHORS",
           "v10Detect",
           "DeformableTransformerDecoderLayer", "Detect", "HGBlock", "HGStem", "LightConv", "MLP",
           "MSDeformAttn", "MultiheadAttention", "OBB", "Pose", "Proto", "RTDETRDecoder", "RepC3", "RepConv",
           "SPPF", "Segment",
           "TransformerEncoderLayer", "autopad", "decode_single_label"]
