"""The plain reference forwards: ROBO_UNet (RoboCupVision model.py:461-536,
the flagship: strided downs, additive skips) and PB_FCN in its
segmentation mode (model.py:269-309 over the DownSampler, model.py:201-232).

Plain PyTorch on NCHW tensors in f32, written from the layer equations of
the reference's blocks:

  Conv (model.py:105-116)            conv -> ReLU -> BN
  ConvPoolSimple (model.py:166-176)  conv -> BN -> ReLU
  ConvPool (model.py:126-142)        dilated conv1 -> ReLU -> stride-2
                                     pool conv -> BN -> ReLU
  upSampleTransposeConv (178-194)    k3/s2/p1/op1 tconv -> BN -> ReLU
  UltClassifier / Classifier         conv (k, padding k // 2)

Parameters are a state_dict: {name: tensor}, conv kernels (out, in, kh,
kw), transposed kernels (in, out, kh, kw). ``train=True`` normalizes by
the batch's statistics (biased variance), as BatchNorm2d does in train
mode. This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5
YUV_FROM_RGB = ((0.299, 0.587, 0.114),
                (-0.14714119, -0.28886916, 0.43601035),
                (0.61497538, -0.51496512, -0.10001026))


def camera_input(x_u8: torch.Tensor) -> torch.Tensor:
    """Raw (N, H, W, 3) uint8 RGB camera frames -> the serving input
    (N, 3, H, W): /255, ToYUV (BT.601, skimage's matrix), then
    Normalize([.5, 0, 0], [.5, .5, .5])."""
    rgb = x_u8.double() / 255.0
    yuv = rgb @ torch.tensor(YUV_FROM_RGB, dtype=torch.float64,
                             device=x_u8.device).T
    mean = torch.tensor((0.5, 0.0, 0.0), dtype=torch.float64,
                        device=x_u8.device)
    return ((yuv - mean) / 0.5).float().permute(0, 3, 1, 2).contiguous()


def bn(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    g = p[name + ".weight"].reshape(1, -1, 1, 1)
    b = p[name + ".bias"].reshape(1, -1, 1, 1)
    if train:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean = p[name + ".running_mean"].reshape(1, -1, 1, 1)
        var = p[name + ".running_var"].reshape(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + EPS) * g + b


def conv(p: Params, name: str, x, stride=1, padding=0, dilation=1):
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"),
                    stride=stride, padding=padding, dilation=dilation)


def conv_block(p, name, x, stride, train):              # Conv
    k = p[name + ".conv.weight"].shape[-1]
    y = conv(p, name + ".conv", x, stride, k // 2)
    return bn(p, name + ".bn", F.relu(y), train)


def conv_pool_simple(p, name, x, stride, padding, dilation, train):
    y = conv(p, name + ".conv", x, stride, padding, dilation)
    return F.relu(bn(p, name + ".bn", y, train))


def conv_pool(p, name, x, train):
    y = F.relu(conv(p, name + ".conv1", x, 1, 2, 2))
    y = conv(p, name + ".pool", y, 2, 1)
    return F.relu(bn(p, name + ".bn", y, train))


def up(p, name, x, train):
    y = F.conv_transpose2d(x, p[name + ".conv.weight"],
                           p.get(name + ".conv.bias"), stride=2, padding=1,
                           output_padding=1)
    return F.relu(bn(p, name + ".bn", y, train))


def robo_unet(p: Params, cfg: dict, x: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    """The flagship ROBO_UNet: (N, 3, H, W) -> (N, classes, H, W) logits.
    Depth ``depth`` (+1 with ``no_scale``); Level0 holds ``levels - 1``
    Conv blocks (at least one), every deeper level a stride-2 Conv and
    ``levels - 1`` more; the PB belly ``belly_size - 1`` Convs to
    ``belly_planes`` and one back; each up adds its skip."""
    if cfg.get("pool") or cfg.get("v2"):
        raise ValueError("the reference holds the flagship ROBO_UNet only")
    depth = cfg["depth"] + (1 if cfg["no_scale"] else 0)
    lv = cfg["levels"]

    def level(name, h, n_convs, stride):
        h = conv_block(p, name + ".layers.Conv0", h, stride, train)
        for i in range(1, n_convs):
            h = conv_block(p, f"{name}.layers.Conv{i}", h, 1, train)
        return h

    downs = [level("downPart.Level0", x, max(lv - 1, 1), 1)]
    for i in range(1, depth):
        downs.append(level(f"downPart.Level{i}", downs[-1], lv, 2))
    h = downs[-1]
    if cfg["belly_size"] > 0:
        h = level("PB.PB_1", h, cfg["belly_size"] - 1, 1)
        h = level("PB.PB_2", h, 1, 1)
    for i in range(depth - 1):
        h = up(p, f"upPart.Up{i}", h, train) + downs[-(i + 2)]
    k = cfg.get("class_size", 1)
    return conv(p, "segmenter.layers.Class", h, 1, k // 2)


def pb_fcn(p: Params, cfg: dict, x: torch.Tensor,
           train: bool = False) -> torch.Tensor:
    """PB_FCN, segmentation mode: (N, 3, H, W) -> (N, classes, H, W)."""
    def cps(name, h, stride, padding, dilation):
        return conv_pool_simple(p, "FCN." + name, h, stride, padding,
                                dilation, train)

    x0 = cps("conv0", x, 1, 2, 2)
    x1 = cps("conv1", x0, 2, 1, 1)
    x2 = conv_pool(p, "FCN.conv2", x1, train)
    feats = [x0, x1, x2]
    h = x2
    if cfg["no_scale"]:
        h = conv_pool(p, "FCN.conv_ext", h, train)
        feats.append(h)
    h = conv_pool(p, "FCN.conv3", h, train)
    for i in range(4, 9):
        h = cps(f"conv{i}", h, 1, 2, 2)
    for j in range(len(feats)):
        h = up(p, f"up{j + 1}", h, train) + feats[-(j + 1)]
    k = cfg.get("kernel_size", 1)
    return conv(p, "segmenter.classifier", h, 1, k // 2)


FORWARDS = {"robo_unet": robo_unet, "pb_fcn": pb_fcn}
