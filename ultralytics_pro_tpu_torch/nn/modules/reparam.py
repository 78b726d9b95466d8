"""UniRepLKNet's block and its global response norm, NCHW, under the JAX
package's parameter names, the large-kernel block of the MAFDetect heads.

Counterpart of `ultralytics_pro_tpu/nn/modules/reparam.py` (`GRN:298`,
`UniRepLKNetBlock:316`) for kernel sizes 3 and 5, whose depth-wise conv is a
single raw conv; at 7 and above the JAX block runs a DilatedReparamBlock
(`:279`), which is not ported (no YAML of the port reaches it). The dense
layers (`se_fc0`, `se_fc1`, `pwconv1`, `pwconv2`) are `nn.Linear` over the
channels, as the flax `nn.Dense` layers are. BatchNorm here is the JAX
module's: eps 1e-5, flax momentum 0.9 (torch's 0.1).

Zero-initialised and tiny parameters: GRN's `gamma` and `beta` start at 0
(GRN is the identity) and the block's layer-scale `gamma` at 1e-6 (the block
all but the identity), so at initialisation the block changes almost
nothing; parity checks seed them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import BatchNorm2d

BN_EPS5 = 1e-5
BN_MOMENTUM9 = 0.1  # flax momentum 0.9


def _bn5(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS5, momentum=BN_MOMENTUM9)


class GRN(nn.Module):
    """Global response norm over a channel-last (B, H, W, C) map: each
    channel's L2 norm over the map, divided by the channels' mean norm plus
    1e-6, scales x by `gamma`, plus `beta`, plus x."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt((x * x).sum((1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
        return x * nx * self.gamma + self.beta + x


class UniRepLKNetBlock(nn.Module):
    """A raw depth-wise k x k conv with no bias (`dwconv`) and `norm`; a
    squeeze-excite gate (`se_fc0` to C / 4, ReLU, `se_fc1`, sigmoid); the
    FFN `pwconv1` to ffn_factor x C, tanh GELU, `grn`, `pwconv2` with no bias,
    `ffn_bn`; times the layer scale `gamma`, plus x. k is 3 or 5."""

    def __init__(self, c: int, k: int = 5, ffn_factor: float = 4.0, ls_init: float = 1e-6):
        super().__init__()
        if k not in (3, 5):
            raise NotImplementedError(f"UniRepLKNetBlock with k={k} runs a DilatedReparamBlock, which is not "
                                      "implemented in ultralytics_pro_tpu_torch; k 3 and 5 are")
        f = int(ffn_factor * c)
        self.dwconv = nn.Conv2d(c, c, k, padding=k // 2, groups=c, bias=False)
        self.norm = _bn5(c)
        self.se_fc0 = nn.Linear(c, max(c // 4, 1))
        self.se_fc1 = nn.Linear(max(c // 4, 1), c)
        self.pwconv1 = nn.Linear(c, f)
        self.grn = GRN(f)
        self.pwconv2 = nn.Linear(f, c, bias=False)
        self.ffn_bn = _bn5(c)
        self.gamma = nn.Parameter(torch.full((c,), ls_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dwconv(x))
        se = torch.sigmoid(self.se_fc1(F.relu(self.se_fc0(y.mean((2, 3))))))
        y = (y * se[:, :, None, None]).permute(0, 2, 3, 1)
        y = self.pwconv2(self.grn(F.gelu(self.pwconv1(y), approximate="tanh")))
        y = self.ffn_bn(y.permute(0, 3, 1, 2))
        return x + y * self.gamma[:, None, None]
