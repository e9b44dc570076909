"""One-call deployment export, model -> (net.cfg, weights.dat) directory,
and its check, the pair run by the cfg interpreter against the live model
(the JAX package's export/deploy.py).

The reference's deployment artifacts (weights/, weightsVGA/, weightsLP/;
tester.py:121-124, validLabelProp.py:79), with the cfg generated from the
model config and the unused classification head left out precisely.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from robocupvision_tpu_torch.export import netcfg, weights_io
from robocupvision_tpu_torch.models.zoo import Model
from robocupvision_tpu_torch.ops import nn


def export_deployment(path: str, model: Model,
                      params: Optional[Dict[str, torch.Tensor]] = None,
                      fname: str = "weights.dat") -> str:
    """Write net.cfg + ``fname`` for a deployable family: PB_FCN
    (segmentation), LabelProp or ROBO-UNet, of ``params`` (the port's
    state_dict; the model's own when None). The JAX tester's ``--dump``
    writes ``weights2.dat`` unless ``--pruned``."""
    os.makedirs(path, exist_ok=True)
    state = model.state_dict() if params is None else params
    fam, cfg = model.family, model.cfg
    if fam == "pb_fcn":
        if cfg.classify:
            raise ValueError("export the segmentation head, not the classifier")
        secs = netcfg.pb_fcn_sections(cfg.planes, cfg.num_classes,
                                      cfg.no_scale, cfg.kernel_size)
        skip = ("classifier.",)
    elif fam == "label_prop":
        secs = netcfg.label_prop_sections(cfg.planes, cfg.num_classes)
        skip = ()
    elif fam == "robo_unet":
        secs = netcfg.robo_unet_sections(cfg)
        skip = ()
    else:
        raise ValueError(f"no deployment graph emitter for family {fam}")
    secs = netcfg.apply_param_widths(secs, model.registry, state, skip)
    netcfg.write_cfg(os.path.join(path, "net.cfg"), secs)
    weights_io.save_params(path, model.registry, state, fname=fname,
                           skip_prefixes=skip)
    return path


def verify_deployment(path: str, model: Model,
                      params: Optional[Dict[str, torch.Tensor]],
                      x_nhwc, fname: str = "weights.dat",
                      atol: float = 1e-4) -> float:
    """Run the exported cfg + ``fname`` pair through ``netcfg.run_cfg`` and
    compare it with the live model's softmaxed logits of ``params`` (the
    port's state_dict; the model's own when None), both on the model's
    device. Returns max |diff|; raises ``AssertionError`` above ``atol``."""
    dev = model.device
    secs = netcfg.parse_cfg(os.path.join(path, "net.cfg"))
    flat = np.fromfile(os.path.join(path, fname), dtype="<f4")
    x = torch.as_tensor(x_nhwc).to(dev)
    state = model.state_dict() if params is None else params
    with torch.no_grad():
        got = netcfg.run_cfg(secs, flat, x)
        ref = nn.softmax(model.apply({k: torch.as_tensor(v).to(dev)
                                      for k, v in state.items()}, x), dim=-1)
    diff = float((got - ref).abs().max())
    if diff > atol:
        raise AssertionError(f"deployment mismatch: max|diff|={diff}")
    return diff
