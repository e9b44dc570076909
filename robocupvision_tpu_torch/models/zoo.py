"""Model zoo: the flagship ROBO-UNet family (reference model.py:461-536),
eval-mode, in its additive-skip form at QVGA and at VGA (``no_scale``).

``make("robo_unet", ...)`` returns a :class:`Model`, an ``nn.Module`` whose
``state_dict`` carries the registry names; its ``forward`` takes NHWC input
and returns NHWC logits, like the JAX package's ``Model.apply``. The
``--v2`` (concat skips) and ``--UNet`` (max-pool downs) variants belong to a
later slice of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.models import layers as L

Params = L.Params


@dataclasses.dataclass(frozen=True)
class RoboUNetCfg:
    no_scale: bool = False
    planes: int = 8
    num_classes: int = 5
    depth: int = 4
    levels: int = 2
    belly_size: int = 5
    belly_planes: int = 128
    pool: bool = False  # vanilla-UNet mode
    v2: bool = False    # concat skips instead of add
    class_size: int = 1

    @property
    def eff_depth(self) -> int:
        return self.depth + 1 if self.no_scale else self.depth

    @property
    def img_shape(self) -> Tuple[int, int]:
        return (240, 320) if self.no_scale else (120, 160)


def robo_unet_registry(cfg: RoboUNetCfg) -> L.Registry:
    r = L.Registry()
    depth = cfg.eff_depth
    pl = cfg.planes
    max_depth = pl * 2 ** (depth - 1)

    L.level_down_def(r, "downPart.Level0", 3, pl, cfg.levels - 1, False, cfg.pool)
    for i in range(depth - 1):
        n_ch = pl * 2 ** i
        L.level_down_def(r, f"downPart.Level{i + 1}", n_ch, n_ch * 2,
                         cfg.levels, True, cfg.pool)
    if cfg.belly_size > 0:
        L.level_down_def(r, "PB.PB_1", max_depth, cfg.belly_planes,
                         cfg.belly_size - 1, False, False)
        L.level_down_def(r, "PB.PB_2", cfg.belly_planes, max_depth, 1, False, False)
    for i in range(depth - 1):
        n_ch = pl * 2 ** (depth - 1 - i)
        o_ch = n_ch // 2
        if i > 0 and cfg.v2:
            n_ch *= 2
        L.up_tconv_def(r, f"upPart.Up{i}", n_ch, o_ch)
    L.ult_classifier_def(r, "segmenter", pl * 2 if cfg.v2 else pl,
                         cfg.num_classes, cfg.class_size)
    return r


def robo_unet_apply(cfg: RoboUNetCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward: NHWC input -> NHWC logits."""
    depth = cfg.eff_depth
    downs = [x]
    downs.append(L.level_down(p, "downPart.Level0", x, cfg.levels - 1, False,
                              cfg.pool))
    for i in range(depth - 1):
        downs.append(L.level_down(p, f"downPart.Level{i + 1}", downs[-1],
                                  cfg.levels, True, cfg.pool))
    if cfg.belly_size > 0:
        h = L.level_down(p, "PB.PB_1", downs[-1], cfg.belly_size - 1, False,
                         False)
        downs[-1] = L.level_down(p, "PB.PB_2", h, 1, False, False)

    up = downs[-1]
    for i in range(depth - 1):
        up = L.up_tconv(p, f"upPart.Up{i}", up) + downs[-(i + 2)]
    return L.ult_classifier(p, "segmenter", up, cfg.class_size)


_FAMILIES = {
    "robo_unet": (RoboUNetCfg, robo_unet_registry, robo_unet_apply),
}


class Model(L.RegistryModule):
    """A zoo architecture with its parameters (registry-named state_dict)."""

    def __init__(self, family: str, cfg, params: Params) -> None:
        super().__init__(_FAMILIES[family][1](cfg), params)
        self.family = family
        self.cfg = cfg

    @property
    def registry(self) -> L.Registry:
        return _FAMILIES[self.family][1](self.cfg)

    @property
    def param_order(self):
        return self.registry.order

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return _FAMILIES[self.family][2](self.cfg, self.flat(), x)


def make(family: str, *, device: DeviceLike = None,
         generator: Optional[torch.Generator] = None, **kwargs) -> Model:
    """Build ``family`` with PyTorch-default initial weights drawn from
    ``generator`` (seed 0 when omitted), on ``device`` (``cuda`` unless the
    caller passes another)."""
    dev = resolve_device(device)
    cfg = _FAMILIES[family][0](**kwargs)
    if cfg.v2 or cfg.pool:
        raise NotImplementedError(
            "the --v2 and --UNet ROBO-UNet variants are not ported yet")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = _FAMILIES[family][1](cfg).init(gen)
    return Model(family, cfg, params).to(dev)
