"""One-call deployment export: model -> (net.cfg, weights.dat) directory
(the JAX package's export/deploy.py ``export_deployment``).

The reference's deployment artifacts (weights/, weightsVGA/, weightsLP/;
tester.py:121-124, validLabelProp.py:79), with the cfg generated from the
model config and the unused classification head left out precisely.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from robocupvision_tpu_torch.export import netcfg, weights_io
from robocupvision_tpu_torch.models.zoo import Model


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
