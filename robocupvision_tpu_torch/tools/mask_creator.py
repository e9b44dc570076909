"""On-disk image/label resize + YUV conversion (the JAX package's
tools/mask_creator.py; reference maskCreator.py:9-34, with the hard-coded
Windows paths made into arguments; host only, no device).

Two modes, like the reference: when the image and label dirs have different
counts, only resize the images; otherwise resize both and convert images to
YUV in place.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

import numpy as np

from robocupvision_tpu_torch.data.datasets import _list_pngs, to_yuv_legacy


def process(img_dir: str, lab_dir: str, img_size=(120, 160)) -> int:
    from PIL import Image

    imgs = _list_pngs(img_dir)
    labs = _list_pngs(lab_dir) if lab_dir and osp.isdir(lab_dir) else []
    h, w = img_size
    if len(labs) != len(imgs):
        for name in imgs:
            p = osp.join(img_dir, name)
            Image.open(p).convert("RGB").resize((w, h), Image.BILINEAR).save(p)
        return len(imgs)
    for iname, lname in zip(imgs, labs):
        ip = osp.join(img_dir, iname)
        rgb = np.asarray(Image.open(ip).convert("RGB").resize(
            (w, h), Image.BILINEAR), np.float32) / 255.0
        yuv = to_yuv_legacy(rgb)
        out = np.clip((yuv - yuv.min()) / max(yuv.max() - yuv.min(), 1e-6)
                      * 255, 0, 255).astype(np.uint8)
        Image.fromarray(out).save(ip)
        lp = osp.join(lab_dir, lname)
        Image.open(lp).convert("I").resize((w, h), Image.NEAREST).convert(
            "L").save(lp)
    return len(imgs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Resize/YUV-convert dataset pairs")
    p.add_argument("--imgDir", required=True)
    p.add_argument("--labDir", default="")
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    opt = p.parse_args(argv)
    n = process(opt.imgDir, opt.labDir, (opt.height, opt.width))
    print(f"processed {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
