"""Combined seg + label-propagation inference dump over LP sequences (the
JAX package's tools/make_lp_images.py).

The reference's makeLPImages.py is unrunnable Python 2 (print statements,
stale imports — SURVEY.md §2.1); this implements its intended behaviour:
for each LabelProp validation sequence, run the segmentation net (PB_FCN,
planes 32, 1x1 classifier) on frame t, propagate with the LP net
(LabelProp, planes 32) to frame t+1, and write colorized (seg, prop) image
pairs. The loop is ``lp_images``; ``main`` writes its maps as PNGs.

    python -m robocupvision_tpu_torch.tools.make_lp_images --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from typing import Iterable, List, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device

NUM_CLASSES = 5


def lp_images(seg, lp, items: Iterable[Tuple[np.ndarray, np.ndarray]]
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """For each (imgs (2, H, W, 3), labels (2, H, W)) frame pair, as
    LPDataSet gives them: the segmentation net's labels of frame 0 and the
    LP net's labels of the pair's first input (frame 0's image with frame
    1's labels, ``build_lp_pairs``), both (H, W) int64 on the host. The
    nets run on their own device."""
    from robocupvision_tpu_torch.cli.labelPropTrain import build_lp_pairs

    out = []
    with torch.no_grad():
        for imgs, labs in items:
            seg_pred = torch.argmax(seg(torch.from_numpy(imgs).to(seg.device)),
                                    dim=-1)
            inputs, _ = build_lp_pairs(imgs[None], labs[None], NUM_CLASSES)
            lp_pred = torch.argmax(lp(torch.from_numpy(inputs).to(lp.device)),
                                   dim=-1)
            out.append((seg_pred[0].cpu().numpy(), lp_pred[0].cpu().numpy()))
    return out


def main(argv=None, device: DeviceLike = None) -> int:
    p = argparse.ArgumentParser(description="Seg + LP inference dump")
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "./data"))
    p.add_argument("--finetuned", action="store_true")
    p.add_argument("--out", type=str, default="output/LPImages")
    opt = p.parse_args(argv)
    dev = resolve_device(device)

    from PIL import Image

    from robocupvision_tpu_torch.data.datasets import LPDataSet
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops.labels import colorize
    from robocupvision_tpu_torch.train import checkpoint

    # trainer.py saves finetuned checkpoints with the camera string inserted
    # (pth/bestModelSegbothFinetuned.pth for the default both-cameras run)
    seg_name = "pth/bestModelSeg" + ("bothFinetuned" if opt.finetuned else "") + ".pth"
    lp_name = "pth/bestModelLP" + ("Finetuned" if opt.finetuned else "") + ".pth"
    ds = LPDataSet(opt.root, train=False, img_size=(120, 160),
                   finetune=opt.finetuned, len_seq=2)
    if len(ds) == 0:
        print(f"No LabelProp data under {opt.root}")
        return -1

    seg = zoo.make("pb_fcn", planes=32, num_classes=NUM_CLASSES,
                   kernel_size=1, device=dev)
    lp = zoo.make("label_prop", num_classes=NUM_CLASSES, planes=32,
                  device=dev)
    seg.load_state_dict(checkpoint.load_any(seg_name, seg.registry))
    lp.load_state_dict(checkpoint.load_any(lp_name, lp.registry))

    maps = lp_images(seg, lp, (ds[i][:2] for i in range(len(ds))))
    os.makedirs(opt.out, exist_ok=True)
    for i, (seg_pred, lp_pred) in enumerate(maps):
        Image.fromarray(colorize(seg_pred)).save(
            osp.join(opt.out, "%d_seg.png" % i))
        Image.fromarray(colorize(lp_pred)).save(
            osp.join(opt.out, "%d_lp.png" % i))
    print(f"wrote {len(ds)} (seg, lp) pairs to {opt.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
