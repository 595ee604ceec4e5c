"""ResNet-34 image encoder truncated at layer2 (stride /8).

Counterpart of ``gmf_tpu/nn/resnet.py``. Module names are torchvision's
(``conv1``, ``bn1``, ``layer1.{i}``, ``layer2.{i}.downsample.{0,1}``),
the names ``gmf_tpu/utils/convert_torch.py::convert_resnet_trunk`` reads.
The public input is NHWC like the JAX package; the trunk runs NCHW and
``ImageEncoder.tokens`` flattens H-then-W, so a 120x160 image gives the
same 15x20 = 300 tokens in the same order. Batch norms keep flax's
running statistics (``nn/norm.py``); convolutions and batch norms take a
``compute_dtype`` (``nn/compute.py``).
"""

from __future__ import annotations

from torch import nn

from gmf_tpu_torch.nn.compute import Conv2d
from gmf_tpu_torch.nn.norm import BatchNorm2d


class BasicBlock(nn.Module):
    """Two 3x3 convs + BN + ReLU with an identity or downsample skip."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.relu = nn.ReLU()
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes, 1, stride=stride, bias=False),
            BatchNorm2d(planes, eps=1e-5),
        ) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """conv1/bn1/relu -> maxpool -> layer1 (3 blocks, w ch) -> layer2
    (4 blocks, 2w ch, /2): ResNet-34 up to layer2."""

    def __init__(self, base_width: int = 64):
        super().__init__()
        w = base_width
        self.conv1 = Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(w, eps=1e-5)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = nn.Sequential(
            *[BasicBlock(w, w) for _ in range(3)])
        self.layer2 = nn.Sequential(*[
            BasicBlock(w if i == 0 else 2 * w, 2 * w,
                       stride=2 if i == 0 else 1, downsample=(i == 0))
            for i in range(4)])

    def forward(self, x):
        """NCHW in, NCHW out."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer2(self.layer1(x))


class ImageEncoder(nn.Module):
    def __init__(self, base_width: int = 64):
        super().__init__()
        self.backbone = ResNet(base_width=base_width)

    def forward(self, x):
        """[B, H, W, 3] -> [B, H/8, W/8, 2*base_width] (NHWC)."""
        return self.backbone(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def tokens(self, x):
        """[B, H, W, 3] -> [B, H*W/64, 2*base_width], row-major tokens."""
        feat = self(x)
        B, H, W, C = feat.shape
        return feat.reshape(B, H * W, C)
