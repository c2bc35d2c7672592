"""Reference-exact ENet (port of dfu3d_tpu/models/penet_ref.py; reference
tools/PENet/model.py:3-234 + basic.py) in eval mode: the depth completion of
the pseudo-box pipeline that loads released PENet checkpoints
(`convert.load_enet_reference`).

Structure (model.py): two geo-conditioned ResNet encoders (rgb + d, then
d + rgb_depth with skip concats from the rgb decoder), mirrored decoders with
additive skips, confidence-softmax fusion of the two depth maps.
BasicBlockGeo (basic.py:279-327) concatenates the geometry feature BEFORE
conv1 as (x, g1) and BEFORE conv2 as (g2, out) — the swapped order is the
reference's — and its downsample conv consumes the (x, g1) concat. The
geometry feature unprojects with the reference's hardcoded 352×1216 image
plane. The transposed convs are torch's own ConvTranspose2d(k=5, s=2, p=2,
output_padding=1), which the JAX package emulates with explicit lax pads.

Tensors are NCHW; submodule names are the JAX package's (rgb_conv_init.conv,
rgb_encoder_layer3.down_bn, decoder_layer6.bn, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .depth_completion import BatchNorm2d


class ConvBnReLU(nn.Module):
    """convbnrelu (basic.py:58): conv (no bias) → BN → ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride, padding, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBnReLU(nn.Module):
    """deconvbnrelu (basic.py:65): ConvTranspose (no bias) → BN → ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 5, stride: int = 2,
                 padding: int = 2, output_padding: int = 1):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_channels, features, kernel, stride, padding,
                                       output_padding, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlockGeo(nn.Module):
    """basic.py:279-327. g1 concat as (x, g1) before conv1; g2 concat as
    (g2, out) before conv2; downsample (1×1 conv + BN) over (x, g1) when the
    stride is not 1 or the channels change."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, geoplanes: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes + geoplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes + geoplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.has_down = stride != 1 or inplanes != planes
        if self.has_down:
            self.down_conv = nn.Conv2d(inplanes + geoplanes, planes, 1, stride, bias=False)
            self.down_bn = BatchNorm2d(planes)

    def forward(self, x, g1, g2):
        xg = torch.cat([x, g1.to(x.dtype)], dim=1)
        out = F.relu(self.bn1(self.conv1(xg)))
        out = self.bn2(self.conv2(torch.cat([g2.to(out.dtype), out], dim=1)))
        identity = self.down_bn(self.down_conv(xg)) if self.has_down else x
        return F.relu(out + identity.to(out.dtype))


def sparse_downsample_close(d, mask, large: float = 600.0):
    """SparseDownSampleClose (basic.py:141-153): stride-2 max-pool of the
    NEAREST valid depth."""
    enc = -(1.0 - mask) * large - d
    d2 = -F.max_pool2d(enc, 2, 2)
    m2 = F.max_pool2d(mask, 2, 2)
    return d2 - (1.0 - m2) * large, m2


def geometry_feature(z, vnorm, unorm, h, w, ch, cw, fh, fw):
    """GeometryFeature (basic.py:270-277): unproject to (x, y, z)."""
    x = z * (0.5 * h * (vnorm + 1.0) - ch) / fh
    y = z * (0.5 * w * (unorm + 1.0) - cw) / fw
    return torch.cat([x, y, z], dim=1)


# (inplanes, planes, stride) ladders, model.py:21-52
RGB_LAYERS = [(32, 64, 2), (64, 64, 1), (64, 128, 2), (128, 128, 1),
              (128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1),
              (512, 1024, 2), (1024, 1024, 1)]
DEPTH_LAYERS = [(32, 64, 2), (64, 64, 1), (128, 128, 2), (128, 128, 1),
                (256, 256, 2), (256, 256, 1), (512, 512, 2), (512, 512, 1),
                (1024, 1024, 2), (1024, 1024, 1)]
RGB_DECODER = [(8, 512), (6, 256), (4, 128), (2, 64), (0, 32)]
FUSION_DECODER = [512, 256, 128, 64, 32]


class ENetRef(nn.Module):
    """model.py ENet with convolutional_layer_encoding='xyz' (geoplanes 3).

    forward(rgb (B, 3, H, W), d (B, 1, H, W), position (B, 2, H, W) [unorm,
    vnorm], K (B, 3, 3)) → dict with rgb_depth / d_depth / output (B, 1, H, W)
    and the concat feature maps the PENet_Cx CSPN stages consume. H and W
    must be multiples of 32. Built on `device` (the card unless "cpu" is
    asked for)."""

    def __init__(self, geoplanes: int = 3, device="cuda"):
        super().__init__()
        gp = geoplanes
        self.rgb_conv_init = ConvBnReLU(4, 32, kernel=5, padding=2)
        for i, (inp, out, st) in enumerate(RGB_LAYERS, start=1):
            self.add_module(f"rgb_encoder_layer{i}", BasicBlockGeo(inp, out, st, gp))
        prev = RGB_LAYERS[-1][1]
        for lvl, ch in RGB_DECODER:
            self.add_module(f"rgb_decoder_layer{lvl}", DeconvBnReLU(prev, ch))
            prev = ch
        self.rgb_decoder_output = DeconvBnReLU(32, 2, kernel=3, stride=1, padding=1,
                                               output_padding=0)
        self.depth_conv_init = ConvBnReLU(2, 32, kernel=5, padding=2)
        for i, (inp, out, st) in enumerate(DEPTH_LAYERS, start=1):
            self.add_module(f"depth_layer{i}", BasicBlockGeo(inp, out, st, gp))
        prev = DEPTH_LAYERS[-1][1]
        for j, ch in enumerate(FUSION_DECODER, start=1):
            self.add_module(f"decoder_layer{j}", DeconvBnReLU(prev, ch))
            prev = ch
        self.decoder_layer6 = ConvBnReLU(32, 2)
        self.to(resolve_device(device)).eval()

    def forward(self, rgb, d, position, K):
        unorm, vnorm = position[:, 0:1], position[:, 1:2]
        f352 = K[:, 1, 1][:, None, None, None]
        c352 = K[:, 1, 2][:, None, None, None]
        f1216 = K[:, 0, 0][:, None, None, None]
        c1216 = K[:, 0, 2][:, None, None, None]

        vns, uns = [vnorm], [unorm]
        for _ in range(5):
            vns.append(F.avg_pool2d(vns[-1], 2, 2))
            uns.append(F.avg_pool2d(uns[-1], 2, 2))
        ds, ms = [d], [torch.where(d > 0, 1.0, 0.0)]
        for _ in range(5):
            d2, m2 = sparse_downsample_close(ds[-1], ms[-1])
            ds.append(d2)
            ms.append(m2)
        # geometry at each scale on the reference's 352×1216 plane (model.py:122-127)
        geo = [geometry_feature(ds[i], vns[i], uns[i], 352 / 2 ** i, 1216 / 2 ** i,
                                c352, c1216, f352, f1216) for i in range(6)]

        # --- rgb branch ---
        rgb_feature = self.rgb_conv_init(torch.cat([rgb, d], dim=1))
        r = [rgb_feature]
        for i in range(1, len(RGB_LAYERS) + 1):
            # layer i consumes (geo_s{i//2+1}, geo_s{(i+1)//2+1}) in the
            # reference's 1-based naming (model.py:149-158)
            r.append(getattr(self, f"rgb_encoder_layer{i}")(r[-1], geo[i // 2],
                                                            geo[(i + 1) // 2]))
        rgb10 = r[10]
        plus = {}
        x = rgb10
        for lvl, _ in RGB_DECODER:
            x = getattr(self, f"rgb_decoder_layer{lvl}")(x)
            x = x + (r[lvl] if lvl > 0 else rgb_feature)
            plus[lvl] = x
        rgb_output = self.rgb_decoder_output(plus[0])
        rgb_depth, rgb_conf = rgb_output[:, 0:1], rgb_output[:, 1:2]

        # --- depth branch (skip concats from the rgb decoder) ---
        s = [self.depth_conv_init(torch.cat([d.to(rgb_depth.dtype), rgb_depth], dim=1))]
        for i in range(1, len(DEPTH_LAYERS) + 1):
            x_in = s[-1]
            if i in (3, 5, 7, 9):  # cat the rgb decoder's skip (model.py:187-199)
                x_in = torch.cat([plus[i - 1], s[-1]], dim=1)
            s.append(getattr(self, f"depth_layer{i}")(x_in, geo[i // 2], geo[(i + 1) // 2]))

        # --- fusion decoder ---
        x = rgb10 + s[10]
        dec = {}
        for j in range(1, len(FUSION_DECODER) + 1):
            x = getattr(self, f"decoder_layer{j}")(x)
            dec[j] = x
            if j < 5:
                x = x + s[10 - 2 * j]
        depth_output = self.decoder_layer6(dec[5])
        d_depth, d_conf = depth_output[:, 0:1], depth_output[:, 1:2]

        conf = torch.softmax(torch.cat([rgb_conf, d_conf], dim=1).float(), dim=1)
        output = conf[:, 0:1] * rgb_depth.float() + conf[:, 1:2] * d_depth.float()
        return {
            "rgb_depth": rgb_depth, "d_depth": d_depth, "output": output,
            # CSPN guide features (model.py:229-234)
            "feat_s1": torch.cat([plus[0], dec[5]], dim=1),
            "feat_s2": torch.cat([plus[2], dec[4]], dim=1),
            "feat_s4": torch.cat([plus[4], dec[3]], dim=1),
        }
