"""Batch-1 mask dump CLI, the reference's ``python detect.py`` (the JAX
package's cli/detect.py; reference detect.py:25-141).

Loads the train.py-family checkpoint (or ``--ckpt``, e.g. a structurally
pruned ``.slim`` artifact of ``--pruneStruct`` / tools.structured_prune,
whose widths flow through the graph and the op counts), prints the
sparsity-aware op counts, labels the val split at batch 1 and writes the
colorized argmax masks (BGR, as the reference's cv2.imwrite) to output/.
The per-frame loop is :func:`detect_frames` (frames in, label maps out);
``main`` reads the PNGs and writes them.

    python -m robocupvision_tpu_torch.cli.detect --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Iterable, List

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mask dumping")
    for flag in ["--finetune", "--v2", "--noScale", "--UNet", "--useDice",
                 "--noBall", "--noGoal", "--noRobot", "--noLine", "--topCam",
                 "--bottomCam"]:
        p.add_argument(flag, action="store_true", default=False)
    p.add_argument("--packed", action="store_true", default=False,
                   help="use the lane-packed inference graph (f32, plain: "
                        "identical masks)")
    p.add_argument("--root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "../../Data/RoboCup"))
    p.add_argument("--ckpt", type=str, default="",
                   help="explicit checkpoint path, e.g. a structurally "
                        "pruned .slim artifact from --pruneStruct / "
                        "structured_prune; slim widths flow through the "
                        "graph and the op counts")
    return p


def detect_model(opt: argparse.Namespace, num_classes: int,
                 device: DeviceLike = None):
    """The ROBO-UNet of detect.py's own hyper table (detect.py:96-100),
    which differs from train.py's."""
    from robocupvision_tpu_torch.models import zoo

    num_planes = 16 if opt.v2 else 8
    levels = 3 if opt.UNet else (1 if opt.v2 else 2)
    depth = 4
    belly_size = 0 if opt.UNet else (2 if opt.v2 else 5)
    belly_planes = num_planes * 2 ** (depth - 1) if opt.v2 \
        else num_planes * 2 ** depth
    return zoo.make("robo_unet", no_scale=opt.noScale,
                    num_classes=num_classes, planes=num_planes, depth=depth,
                    levels=levels, belly_size=belly_size,
                    belly_planes=belly_planes, pool=opt.UNet, v2=opt.v2,
                    device=device)


def make_infer(model, params, packed: bool
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(1, H, W, 3) f32 frame -> (1, H, W) labels of ``model`` with
    ``params`` (the port's state_dict, dense or slim) on the model's
    device: the f32 packed graph's (plain, no fused chains, as the JAX
    CLI builds it) with ``packed``, else the zoo apply's argmax."""
    dev = model.device
    if packed:
        from robocupvision_tpu_torch.models import packed as packed_mod

        return packed_mod.build_packed_infer(model, params, torch.float32,
                                             device=dev).infer
    p = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    return lambda x: torch.argmax(model.apply(p, x), dim=-1)


def detect_frames(infer: Callable[[torch.Tensor], torch.Tensor],
                  frames: Iterable[np.ndarray], device) -> List[np.ndarray]:
    """Label each (H, W, 3) f32 frame at batch 1: the (H, W) label maps
    on the host."""
    out = []
    with torch.no_grad():
        for img in frames:
            x = torch.as_tensor(np.asarray(img, np.float32)[None]).to(device)
            out.append(infer(x)[0].cpu().numpy())
    return out


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)

    from robocupvision_tpu_torch.data.datasets import SSYUVDataset
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops.labels import colorize
    from robocupvision_tpu_torch.train import checkpoint, naming

    flags = naming.Flags(finetune=opt.finetune, v2=opt.v2, no_scale=opt.noScale,
                         unet=opt.UNet, no_ball=opt.noBall, no_goal=opt.noGoal,
                         no_robot=opt.noRobot, no_line=opt.noLine,
                         top_cam=opt.topCam, bottom_cam=opt.bottomCam)
    if flags.num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    dev = resolve_device(device)
    no_tf32()
    camera = flags.camera
    if camera != "both" and not opt.finetune:
        print("You can only select camera images for the finetune dataset. "
              "Using both cameras by default")
        camera = "both"

    scale = 2 if opt.noScale else 4
    lab_size = (480 // scale, 640 // scale)
    weights_path = opt.ckpt or (naming.test_ckpt_glob_base(flags) + ".weights")

    ds = SSYUVDataset(opt.root, lab_size, False, opt.finetune, camera)
    if len(ds) == 0:
        print(f"No data found under {opt.root}")
        return -1

    print("#" * 54)
    print("##################### Detection ######################")
    print("#" * 54)

    model = detect_model(opt, flags.num_classes, dev)
    params = checkpoint.load_any(weights_path, model.registry)
    comp = zoo.robo_unet_get_computations(model.cfg, params, pruned=True)
    print([round(c) for c in comp])
    print(round(sum(comp)))
    infer = make_infer(model, params, opt.packed)

    os.makedirs("output", exist_ok=True)
    print("\nPerforming object detection:")
    from PIL import Image

    labels = detect_frames(infer, (ds[i][0] for i in range(len(ds))), dev)
    for i, pred in enumerate(labels):
        mask = colorize(pred, 5)[..., ::-1]  # BGR on disk, as cv2.imwrite
        Image.fromarray(np.ascontiguousarray(mask)).save("output/%d.png" % i)
    print(f"wrote {len(ds)} masks to output/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
