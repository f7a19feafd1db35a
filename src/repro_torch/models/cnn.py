"""The paper's backbones as split-able lists of ``Stage`` modules.

Counterpart of ``repro.models.cnn``: ResNet-18, GoogleNet and MobileNetV2
(GroupNorm in place of BatchNorm) plus the small ``tinycnn``, with the same
stage names, depth weights and parameter trees. Tensors are NCHW in
``channels_last`` memory; the public entry ``apply_stages`` in
``core.split`` takes the reference's NHWC input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.split import Stage
from .modules import Conv2d, GroupNorm, Linear, max_pool_same, relu6


class ConvGN(nn.Module):
    """conv -> GroupNorm -> activation (``"relu"``, ``"relu6"`` or None);
    the reference's ``_conv_gn_relu`` param tree ``{"conv", "gn"}``."""

    def __init__(self, k, cin, cout, *, stride=1, groups=1, act="relu"):
        super().__init__()
        self.conv = Conv2d(k, cin, cout, stride=stride, groups=groups)
        self.gn = GroupNorm(cout)
        self.act = act

    def forward(self, x):
        y = self.gn(self.conv(x))
        if self.act == "relu":
            return F.relu(y)
        if self.act == "relu6":
            return relu6(y)
        return y


class PooledConvGN(ConvGN):
    """ResNet stem: conv-gn-relu then a 3x3 stride-2 SAME max-pool."""

    def forward(self, x):
        return max_pool_same(super().forward(x), 3, 2)


class MeanLinear(Linear):
    """Head: global mean over H, W, then ``x @ w + b``."""

    def forward(self, x):
        return super().forward(x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# ResNet-18
# ---------------------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.c1 = ConvGN(3, cin, cout, stride=stride)
        self.c2 = ConvGN(3, cout, cout, act=None)
        self.proj = (ConvGN(1, cin, cout, stride=stride, act=None)
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = self.c2(self.c1(x))
        sc = self.proj(x) if self.proj is not None else x
        return F.relu(y + sc)


def resnet18_stages(num_classes: int = 12, *, width: int = 64) -> list[Stage]:
    w = width
    plan = [(w, w, 1), (w, w, 1),
            (w, 2 * w, 2), (2 * w, 2 * w, 1),
            (2 * w, 4 * w, 2), (4 * w, 4 * w, 1),
            (4 * w, 8 * w, 2), (8 * w, 8 * w, 1)]
    stages = [Stage("stem", PooledConvGN(7, 3, w, stride=2), depth=1)]
    for i, (cin, cout, s) in enumerate(plan):
        stages.append(Stage(f"block{i}", BasicBlock(cin, cout, s), depth=2))
    stages.append(Stage("head", MeanLinear(8 * w, num_classes), depth=1))
    return stages


# ---------------------------------------------------------------------------
# GoogleNet (inception v1, GN instead of LRN/BN, aux heads omitted)
# ---------------------------------------------------------------------------

class Inception(nn.Module):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, cp, *, pool_after=False):
        super().__init__()
        self.b1 = ConvGN(1, cin, c1)
        self.b3r = ConvGN(1, cin, c3r)
        self.b3 = ConvGN(3, c3r, c3)
        self.b5r = ConvGN(1, cin, c5r)
        self.b5 = ConvGN(5, c5r, c5)
        self.bp = ConvGN(1, cin, cp)
        self.pool_after = pool_after

    def forward(self, x):
        y = torch.cat([self.b1(x), self.b3(self.b3r(x)), self.b5(self.b5r(x)),
                       self.bp(max_pool_same(x, 3, 1))], dim=1)
        return max_pool_same(y, 3, 2) if self.pool_after else y


class GoogLeNetStem(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = ConvGN(7, 3, 64, stride=2)
        self.c2 = ConvGN(1, 64, 64)
        self.c3 = ConvGN(3, 64, 192)

    def forward(self, x):
        y = max_pool_same(self.c1(x), 3, 2)
        return max_pool_same(self.c3(self.c2(y)), 3, 2)


def googlenet_stages(num_classes: int = 12) -> list[Stage]:
    inc = {
        "3a": (192, 64, 96, 128, 16, 32, 32),
        "3b": (256, 128, 128, 192, 32, 96, 64),
        "4a": (480, 192, 96, 208, 16, 48, 64),
        "4b": (512, 160, 112, 224, 24, 64, 64),
        "4c": (512, 128, 128, 256, 24, 64, 64),
        "4d": (512, 112, 144, 288, 32, 64, 64),
        "4e": (528, 256, 160, 320, 32, 128, 128),
        "5a": (832, 256, 160, 320, 32, 128, 128),
        "5b": (832, 384, 192, 384, 48, 128, 128),
    }
    stages = [Stage("stem", GoogLeNetStem(), depth=3)]
    for name, cfg in inc.items():
        stages.append(Stage(f"inc{name}",
                            Inception(*cfg, pool_after=name in ("3b", "4e")),
                            depth=2))
    stages.append(Stage("head", MeanLinear(1024, num_classes), depth=1))
    return stages


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, *, stride, expand):
        super().__init__()
        hid = cin * expand
        self.pw1 = ConvGN(1, cin, hid, act="relu6") if expand != 1 else None
        self.dw = ConvGN(3, hid, hid, stride=stride, groups=hid, act="relu6")
        self.pw2 = ConvGN(1, hid, cout, act=None)   # linear bottleneck
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.pw1(x) if self.pw1 is not None else x
        y = self.pw2(self.dw(y))
        return y + x if self.residual else y


class MobileNetHead(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.pw = ConvGN(1, 320, 1280, act="relu6")
        self.fc = Linear(1280, num_classes)

    def forward(self, x):
        return self.fc(self.pw(x).mean(dim=(2, 3)))


def mobilenetv2_stages(num_classes: int = 12) -> list[Stage]:
    # (expand, cout, n, stride) — the paper's Table 2
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    stages = [Stage("stem", ConvGN(3, 3, 32, stride=2, act="relu6"), depth=1)]
    cin = 32
    for i, (t, c, n, s) in enumerate(cfg):
        for j in range(n):
            stages.append(Stage(
                f"ir{i}_{j}",
                InvertedResidual(cin, c, stride=s if j == 0 else 1, expand=t),
                depth=1))
            cin = c
    stages.append(Stage("head", MobileNetHead(num_classes), depth=2))
    return stages


# ---------------------------------------------------------------------------
# tiny CNN (not a paper backbone — fast stand-in for tests)
# ---------------------------------------------------------------------------

def tiny_cnn_stages(num_classes: int = 12, *, width: int = 8) -> list[Stage]:
    w = width
    return [Stage("stem", ConvGN(3, 3, w, stride=2), depth=1),
            Stage("block", ConvGN(3, w, 2 * w, stride=2), depth=1),
            Stage("head", MeanLinear(2 * w, num_classes), depth=1)]


CNN_BUILDERS = {
    "resnet18": resnet18_stages,
    "googlenet": googlenet_stages,
    "mobilenetv2": mobilenetv2_stages,
    "tinycnn": tiny_cnn_stages,
}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()
