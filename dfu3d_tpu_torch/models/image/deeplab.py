"""DDNDeepLabV3, CaDDN's depth-distribution network as the reference ships
it (port of dfu3d_tpu/models/image/deeplab.py; reference ddn_deeplabv3.py
over torchvision's deeplabv3_resnet50 / 101).

A ResNet of bottlenecks with the DeepLab stride-to-dilation plan (layer3
and layer4 keep stride 1 and dilate 2 and 4, the first block of each at the
previous dilation: output stride 8), ASPP (1×1, 3×3 at rates 12 / 24 / 36
and the image-pooling branch, projected 5 · 256 → 256, then Dropout(0.5)
in training with a `dropout` generator), the head (3×3 conv, BN, ReLU, 1×1
to D + 1 logits) and the logits resized bilinearly to layer1's features,
which are the DDN's features. The preprocess normalises by ImageNet's
statistics and keeps zero-padded pixels at 0. NHWC in and out.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..roi_head import dropout_keep
from .common import StridedConv1x1, image_bn, resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESNET_LAYERS = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3)}
# per layer: planes, stride, dilation of its first block, dilation of the rest
PLAN = ((64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 1, 2), (512, 1, 2, 4))


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1, bias: bool = False):
    return nn.Conv2d(cin, cout, k, stride, dilation * (k // 2), dilation, bias=bias)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride, dilation) → 1×1 to 4 · planes, each with BN, plus
    the input or its strided 1×1 projection (down_conv, down_bn), ReLU."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, planes, 1), image_bn(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, stride, dilation), image_bn(planes)
        self.conv3, self.bn3 = conv(planes, planes * 4, 1), image_bn(planes * 4)
        if downsample:
            self.down_conv = StridedConv1x1(cin, planes * 4, stride)
            self.down_bn = image_bn(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(y + idn)


class ASPP(nn.Module):
    def __init__(self, cin: int, channels: int = 256, rates: Tuple[int, ...] = (12, 24, 36)):
        super().__init__()
        self.aspp_conv0, self.aspp_bn0 = conv(cin, channels, 1), image_bn(channels)
        self.rates = tuple(rates)
        for j, r in enumerate(self.rates):
            self.add_module(f"aspp_conv{j + 1}", conv(cin, channels, 3, dilation=r))
            self.add_module(f"aspp_bn{j + 1}", image_bn(channels))
        self.aspp_pool_conv, self.aspp_pool_bn = conv(cin, channels, 1), image_bn(channels)
        n = len(self.rates) + 2
        self.aspp_project, self.aspp_project_bn = conv(n * channels, channels, 1), image_bn(channels)

    def forward(self, x, dropout=None):
        """x NCHW; `dropout`, a generator, engages the Dropout(0.5) in
        training (flax's, without a "dropout" rng, does not)."""
        branches = [F.relu(self.aspp_bn0(self.aspp_conv0(x)))]
        for j in range(len(self.rates)):
            branches.append(F.relu(getattr(self, f"aspp_bn{j + 1}")(
                getattr(self, f"aspp_conv{j + 1}")(x))))
        p = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        p = F.relu(self.aspp_pool_bn(self.aspp_pool_conv(p)))
        branches.append(p.expand_as(branches[0]))
        y = torch.cat([b.to(x.dtype) for b in branches], dim=1)
        y = F.relu(self.aspp_project_bn(self.aspp_project(y)))
        if self.training and dropout is not None:
            y = torch.where(dropout_keep(dropout, y.shape, 0.5, y.device), y / 0.5, 0.0)
        return y


class DDNDeepLabV3(nn.Module):
    """images (B, H, W, 3) in [0, 1] → (layer1 features (B, H/4, W/4, 256),
    logits (B, H/4, W/4, num_classes) fp32); num_classes = D + 1."""

    def __init__(self, num_classes: int, layers=RESNET_LAYERS["ResNet101"],
                 pretrained_preprocess: bool = True):
        super().__init__()
        self.layers = tuple(layers)
        self.pretrained_preprocess = pretrained_preprocess
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = image_bn(64)
        cin = 64
        for li, ((planes, stride, dil0, dil), n) in enumerate(zip(PLAN, self.layers), start=1):
            for i in range(n):
                down = i == 0 and (stride != 1 or cin != planes * 4)
                self.add_module(f"layer{li}_{i}", Bottleneck(
                    cin, planes, stride if i == 0 else 1, dil0 if i == 0 else dil, down))
                cin = planes * 4
        self.out_channels = PLAN[0][0] * 4
        self.aspp = ASPP(cin)
        self.head_conv, self.head_bn = conv(256, 256, 3), image_bn(256)
        self.head_out = nn.Conv2d(256, num_classes, 1)

    def preprocess(self, images):
        x = images.float()
        if self.pretrained_preprocess:
            x = torch.where(x == 0, 0.0, (x - self.mean) / self.std)
        return x

    def resnet_layer(self, li: int, x):
        for i in range(self.layers[li - 1]):
            x = getattr(self, f"layer{li}_{i}")(x)
        return x

    def forward(self, images, dropout=None):
        x = self.preprocess(images).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = x = self.resnet_layer(1, x)
        for li in (2, 3, 4):
            x = self.resnet_layer(li, x)
        y = self.aspp(x, dropout)
        y = F.relu(self.head_bn(self.head_conv(y)))
        y = self.head_out(y).float().permute(0, 2, 3, 1)
        logits = resize_bilinear(y, feats.shape[2:4])
        return feats.permute(0, 2, 3, 1), logits
