"""The segmentation and label-propagation dataset readers (the JAX
package's data/datasets.py ``SSYUVDataset``, ``SSDataSet``, ``LPDataSet``
and their helpers).

SSYUVDataset (reference dataset.py:65-133): the main segmentation set,
root[/FinetuneHorizon]/{train,val}/{images,labels}/*.png with the same
camera sidecars. Despite its name the reference never converts these
images to YUV: they come back as RGB normalized with the domain's
constants, (H, W, 3) float32, labels (H, W) int32.

SSDataSet (reference dataset.py:135-189, trainer.py:75-104):
root/{split}/{images,labels}/*.png, sorted by the reference's alphanumeric
key, with optional per-image camera sidecars ``*.txt`` holding 'u' (top) or
'b' (bottom). Images pass the Scale -> ToYUV -> Normalize([.5, 0, 0],
[.5, .5, .5]) stack and come back as (H, W, 3) float32 numpy arrays, labels
as (H, W) int32.

ImageFolder (classTrainer.py:48-53): root/<class>/<image>, classes in
sorted order, images through ToYUV -> Normalize([.5, 0, 0], [.5, .5, .5]).

LPDataSet (reference dataset.py:191-270):
root/LabelProp/{Real,Synthetic}/{train,val}/<seq>/{images,labels}/*.png;
an item is ``len_seq`` consecutive frames of one sequence.

Pillow is imported inside the functions that read files, so that importing
this module needs no Pillow.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from robocupvision_tpu_torch.ops import color as color_ops

# BT.601 matrix (skimage.color.yuv_from_rgb) for the legacy ToYUV stack
_YUV_FROM_RGB = np.array([[0.299, 0.587, 0.114],
                          [-0.14714119, -0.28886916, 0.43601035],
                          [0.61497538, -0.51496512, -0.10001026]])


def alphanum_key(s: str):
    return [int(c) if c.isdigit() else c for c in re.split(r"([0-9]+)", s)]


def _list_files(d: str, ext: str) -> List[str]:
    if not osp.isdir(d):
        return []
    return sorted([f for f in os.listdir(d) if f.endswith(ext)],
                  key=alphanum_key)


def _list_pngs(d: str) -> List[str]:
    return _list_files(d, ".png")


def _camera_filter(img_dir: str, imgs: Sequence[str], labs: Sequence[str],
                   camera: str) -> Tuple[List[str], List[str]]:
    """Keep the frames of ``camera`` ("top", "bottom" or "both"); without
    one sidecar per image every frame is kept."""
    txts = _list_files(img_dir, ".txt")
    if len(txts) != len(imgs):
        return list(imgs), list(labs)
    keep_i, keep_l = [], []
    for img, lab, txt in zip(imgs, labs, txts):
        with open(osp.join(img_dir, txt)) as f:
            char = f.read()
        if (camera == "both" or (camera == "top" and char == "u")
                or (camera == "bottom" and char == "b")):
            keep_i.append(img)
            keep_l.append(lab)
    return keep_i, keep_l


def load_image_rgb(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """PNG -> (H, W, 3) float32 in [0, 1]; PIL bilinear resize to (h, w)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and (img.size[1], img.size[0]) != tuple(size):
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_label(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """PNG -> (H, W) int32; PIL nearest resize."""
    from PIL import Image

    lab = Image.open(path).convert("I")
    if size is not None and (lab.size[1], lab.size[0]) != tuple(size):
        lab = lab.resize((size[1], size[0]), Image.NEAREST)
    return np.asarray(lab, dtype=np.int32)


def to_yuv_legacy(img01: np.ndarray) -> np.ndarray:
    """The legacy transform stack's colour conversion (transform.py:21-24)."""
    return (img01 @ _YUV_FROM_RGB.T).astype(np.float32)


def legacy_normalize(img01: np.ndarray) -> np.ndarray:
    """ToYUV, then Normalize([.5, 0, 0], [.5, .5, .5]), as float32."""
    img = to_yuv_legacy(img01)
    img = (img - np.array([0.5, 0.0, 0.0], np.float32)) / np.float32(0.5)
    return img.astype(np.float32)


class SSYUVDataset:
    """The main segmentation dataset (reference dataset.py:65-133): items
    are (normalized RGB image (H, W, 3), label (H, W)) at ``img_size``."""

    def __init__(self, root: str, img_size=(120, 160), train: bool = True,
                 finetune: bool = False, camera: str = "both"):
        self.img_size = tuple(img_size)
        self.train = train
        if finetune:
            root = osp.join(root, "FinetuneHorizon")
        data_dir = osp.join(root, "train" if train else "val")
        self.img_dir = osp.join(data_dir, "images")
        self.lab_dir = osp.join(data_dir, "labels")
        self.mean = color_ops.MEAN_FINETUNE if finetune else color_ops.MEAN_SYNTHETIC
        self.std = color_ops.STD_FINETUNE if finetune else color_ops.STD_SYNTHETIC
        imgs = _list_pngs(self.img_dir)
        labs = _list_pngs(self.lab_dir)
        self.images, self.labels = _camera_filter(self.img_dir, imgs, labs,
                                                  camera)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        img = load_image_rgb(osp.join(self.img_dir, self.images[i]),
                             self.img_size)
        lab = load_label(osp.join(self.lab_dir, self.labels[i]), self.img_size)
        img = (img - np.asarray(self.mean, np.float32)) \
            / np.asarray(self.std, np.float32)
        return img.astype(np.float32), lab

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every item stacked: (N, H, W, 3) images, (N, H, W) labels."""
        if not len(self):
            return (np.zeros((0,) + self.img_size + (3,), np.float32),
                    np.zeros((0,) + self.img_size, np.int32))
        items = [self[i] for i in range(len(self))]
        return (np.stack([img for img, _ in items]),
                np.stack([lab for _, lab in items]))


class SSDataSet:
    """Legacy segmentation dataset with the Scale/ToYUV/Normalize stack
    (reference dataset.py:135-189 + trainer.py:75-104)."""

    def __init__(self, root: str, split: str = "train", camera: str = "both",
                 scale: int = 4):
        self.scale = scale
        data_dir = osp.join(root, split)
        self.img_dir = osp.join(data_dir, "images")
        self.lab_dir = osp.join(data_dir, "labels")
        imgs = _list_pngs(self.img_dir)
        labs = _list_pngs(self.lab_dir)
        self.images, self.labels = _camera_filter(self.img_dir, imgs, labs,
                                                  camera)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        path = osp.join(self.img_dir, self.images[i])
        size = None
        if self.scale != 1:
            from PIL import Image

            with Image.open(path) as im:
                w, h = im.size
            size = (int(h / self.scale), int(w / self.scale))
        img = legacy_normalize(load_image_rgb(path, size))
        lab = load_label(osp.join(self.lab_dir, self.labels[i]), size)
        return img, lab

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every item stacked: (N, H, W, 3) images, (N, H, W) labels."""
        items = [self[i] for i in range(len(self))]
        return (np.stack([img for img, _ in items]),
                np.stack([lab for _, lab in items]))


class LPDataSet:
    """Label-propagation sequence dataset (reference dataset.py:191-270).

    ``__getitem__`` returns (imgs (S, H, W, 3) YUV, normalized with the
    domain's constants; labels (S, H, W) int32; gray (S, H, W) uint8 frames
    for optical flow)."""

    def __init__(self, root: str, train: bool = True, img_size=(120, 160),
                 finetune: bool = True, len_seq: int = 2):
        self.img_size = tuple(img_size)
        self.len_seq = len_seq
        self.mean = color_ops.MEAN_FINETUNE if finetune else color_ops.MEAN_SYNTHETIC
        self.std = color_ops.STD_FINETUNE if finetune else color_ops.STD_SYNTHETIC
        base = osp.join(root, "LabelProp", "Real" if finetune else "Synthetic",
                        "train" if train else "val")
        self.seqs: List[Tuple[List[str], List[str]]] = []
        if osp.isdir(base):
            for d in sorted(os.listdir(base)):
                cur = osp.join(base, d)
                if not osp.isdir(cur):
                    continue
                idir, ldir = osp.join(cur, "images"), osp.join(cur, "labels")
                self.seqs.append(([osp.join(idir, f) for f in _list_pngs(idir)],
                                  [osp.join(ldir, f) for f in _list_pngs(ldir)]))

    def __len__(self) -> int:
        return sum(max(len(i) - self.len_seq + 1, 0) for i, _ in self.seqs)

    def _locate(self, index: int) -> Tuple[int, int]:
        for d, (imgs, _) in enumerate(self.seqs):
            n = max(len(imgs) - self.len_seq + 1, 0)
            if index < n:
                return d, index
            index -= n
        raise IndexError(index)

    def __getitem__(self, index: int):
        d, item = self._locate(index)
        imgs, labs, grays = [], [], []
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        for i in range(self.len_seq):
            rgb = load_image_rgb(self.seqs[d][0][item + i], self.img_size)
            # the reference converts with cv2's RGB2YUV (dataset.py:260)
            yuv = (_cv2_rgb2yuv(rgb) - mean) / std
            imgs.append(yuv.astype(np.float32))
            labs.append(load_label(self.seqs[d][1][item + i], self.img_size))
            grays.append((np.clip(rgb @ np.array([0.299, 0.587, 0.114]), 0, 1)
                          * 255).astype(np.uint8))
        return np.stack(imgs), np.stack(labs), np.stack(grays)


def _cv2_rgb2yuv(rgb01: np.ndarray) -> np.ndarray:
    """cv2.COLOR_RGB2YUV on [0, 1] floats: Y = BT.601 luma; U, V offset by
    0.5."""
    m = np.array([[0.299, 0.587, 0.114],
                  [-0.14713769, -0.28886174, 0.43599929],
                  [0.61499662, -0.51498428, -0.10001026]], np.float32)
    yuv = rgb01 @ m.T
    yuv[..., 1:] += 0.5
    return yuv


class ImageFolder:
    """Class-per-subdirectory classification dataset (torchvision-free):
    items are (YUV-normalized image (H, W, 3) float32, class index), the
    classTrainer transform stack (classTrainer.py:48-53)."""

    def __init__(self, root: str, yuv: bool = True):
        self.root = root
        self.yuv = yuv
        self.classes = sorted(d for d in os.listdir(root)
                              if osp.isdir(osp.join(root, d))) \
            if osp.isdir(root) else []
        self.samples: List[Tuple[str, int]] = []
        for ci, c in enumerate(self.classes):
            cdir = osp.join(root, c)
            for f in sorted(os.listdir(cdir), key=alphanum_key):
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                    self.samples.append((osp.join(cdir, f), ci))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, lab = self.samples[i]
        img = load_image_rgb(path)
        if self.yuv:
            img = to_yuv_legacy(img)
        img = (img - np.array([0.5, 0.0, 0.0], np.float32)) / np.float32(0.5)
        return img.astype(np.float32), lab

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every item stacked: (N, H, W, 3) images, (N,) int32 classes."""
        items = [self[i] for i in range(len(self))]
        return (np.stack([img for img, _ in items]),
                np.asarray([lab for _, lab in items], np.int32))
