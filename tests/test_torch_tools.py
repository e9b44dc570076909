"""The port's host tools against the JAX package's, on the same inputs:
dbconvert (anchors and the detection DB byte for byte, with cv2 and
scikit-learn and with their fallbacks), label_extraction and its majority
filter, mask_creator (the rewritten PNGs byte for byte), and
make_lp_images (its label maps and PNGs against the JAX tool's from the
same checkpoints)."""

import os
import os.path as osp
import pickle
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

import jax

sys.path.insert(0, os.path.dirname(__file__))
from synth_data import make_lp_tree, make_seg_tree  # noqa: E402

from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.tools import dbconvert as jdbconvert  # noqa: E402
from robocupvision_tpu.tools import label_extraction as jlabel_extraction  # noqa: E402
from robocupvision_tpu.tools import make_lp_images as jmake_lp_images  # noqa: E402
from robocupvision_tpu.tools import mask_creator as jmask_creator  # noqa: E402
from robocupvision_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from robocupvision_tpu_torch.tools import (dbconvert, label_extraction,  # noqa: E402
                                           make_lp_images, mask_creator)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fallback", [False, True])
def test_dbconvert(tmp_path, monkeypatch, fallback):
    """Anchors (bMean/rMean/gMean.npy) and preds.pickle equal the JAX
    tool's bit for bit; ``fallback``: without cv2 and scikit-learn (scipy's
    components, the Lloyd's fallback) in both."""
    if fallback:
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    outs = {}
    for tag, tool in (("jax", jdbconvert), ("port", dbconvert)):
        root = str(tmp_path / tag)
        make_seg_tree(root, n_train=8, n_val=8, size=(64, 80), cameras=False)
        assert tool.main(["--root", root, "--splits", "val"]) == 0
        outs[tag] = osp.join(root, "val")
    data_dir = outs["port"]
    for name in ("bMean.npy", "rMean.npy", "gMean.npy"):
        assert _read(osp.join(data_dir, name)) \
            == _read(osp.join(outs["jax"], name)), name
    assert np.load(osp.join(data_dir, "bMean.npy")).shape == (4,)
    assert np.load(osp.join(data_dir, "rMean.npy")).shape[1] == 4
    with open(osp.join(data_dir, "preds.pickle"), "rb") as f:
        preds = pickle.load(f)
    with open(osp.join(outs["jax"], "preds.pickle"), "rb") as f:
        jpreds = pickle.load(f)
    assert len(preds) == len(jpreds) == 8
    for p, q in zip(preds, jpreds):
        assert isinstance(p[0], str) and p[0] == q[0] and len(p) == len(q)
        for a, b in zip(p[1:], q[1:]):
            assert a[0] == b[0] and a[0] in (1, 2, 3) and a[1].shape == (4,)
            np.testing.assert_array_equal(a[1], b[1])


def test_detect_objects_caps_and_area_filters():
    lab = np.zeros((60, 80), np.uint8)
    lab[5:15, 5:15] = 1          # 100 px
    lab[30:33, 30:33] = 1        # 9 px -> filtered
    lab[40:58, 10:40] = 2        # 540 px
    for i in range(4):           # four goals above the area floor, cap 2
        lab[2:12, 50 + 7 * i:56 + 7 * i] = 3
    dets = dbconvert.detect_objects(lab)
    classes = [d[0] for d in dets]
    assert classes.count(1) == 1 and classes.count(2) == 1
    assert classes.count(3) == 2
    want = jdbconvert.detect_objects(lab)
    assert [d[0] for d in want] == classes
    for a, b in zip(dets, want):
        np.testing.assert_array_equal(a[1], b[1])


def _mask_dir(tmp_path, h, w):
    mask_dir = str(tmp_path / "masks") + "/"
    os.makedirs(mask_dir)
    # legend: ids 1-2 -> Ball, 3-4 -> Robot ; LabelConfig: Ball->1 Robot->2
    with open(osp.join(mask_dir, "legend.leg"), "w") as f:
        f.write("2:Ball 2:Robot\n")
    with open(osp.join(mask_dir, "LabelConfig.cfg"), "w") as f:
        f.write("Ball:1\nRobot:2\n")
    rng = np.random.default_rng(3)
    for i in range(2):
        grid = rng.integers(0, 5, (h, w)) * (rng.random((h, w)) < 0.3)
        with open(osp.join(mask_dir, f"m{i}.txt"), "w") as f:
            for row in grid:
                f.write(" ".join(str(v) for v in row) + "\n")
    return mask_dir


@pytest.mark.parametrize("denoise", [False, True])
def test_label_extraction(tmp_path, denoise):
    h, w = 6, 8
    mask_dir = _mask_dir(tmp_path, h, w)
    out_dir, jout_dir = str(tmp_path / "out"), str(tmp_path / "jout")
    assert label_extraction.extract(mask_dir, out_dir, height=h, width=w,
                                     denoise=denoise) == 2
    assert jlabel_extraction.extract(mask_dir, jout_dir, height=h, width=w,
                                     denoise=denoise) == 2
    for i in range(2):
        assert _read(osp.join(out_dir, f"m{i}.png")) \
            == _read(osp.join(jout_dir, f"m{i}.png"))
    grid = np.loadtxt(osp.join(mask_dir, "m0.txt"), dtype=np.int64)
    lab = np.asarray(Image.open(osp.join(out_dir, "m0.png")))
    if not denoise:
        np.testing.assert_array_equal(lab, np.select(
            [(grid >= 1) & (grid <= 2), (grid >= 3) & (grid <= 4)], [1, 2], 0))


def test_majority_filter_denoises_salt():
    lab = np.zeros((20, 20), np.uint8)
    lab[10, 10] = 3  # single salt pixel
    out = label_extraction.majority_filter(lab)
    assert out[10, 10] == 0
    noisy = np.random.default_rng(4).integers(0, 5, (24, 30)).astype(np.uint8)
    np.testing.assert_array_equal(label_extraction.majority_filter(noisy),
                                  jlabel_extraction.majority_filter(noisy))


@pytest.mark.parametrize("with_labels", [True, False])
def test_mask_creator(tmp_path, with_labels):
    """Both modes (images and labels resized, images converted to YUV; or,
    when the counts differ, images resized only): the rewritten files equal
    the JAX tool's byte for byte."""
    rng = np.random.default_rng(5)
    dirs = {}
    for tag in ("port", "jax"):
        img_dir, lab_dir = str(tmp_path / tag / "imgs"), str(tmp_path / tag / "labs")
        os.makedirs(img_dir)
        os.makedirs(lab_dir)
        dirs[tag] = (img_dir, lab_dir)
    for i in range(3):
        img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        lab = rng.integers(0, 5, (40, 50)).astype(np.uint8)
        for img_dir, lab_dir in dirs.values():
            Image.fromarray(img).save(osp.join(img_dir, f"{i}.png"))
            if with_labels or i < 2:
                Image.fromarray(lab).save(osp.join(lab_dir, f"{i}.png"))
    assert mask_creator.process(*dirs["port"], (20, 24)) == 3
    assert jmask_creator.process(*dirs["jax"], (20, 24)) == 3
    for k in (0, 1):
        for i in range(3 if (k == 0 or with_labels) else 2):
            assert _read(osp.join(dirs["port"][k], f"{i}.png")) \
                == _read(osp.join(dirs["jax"][k], f"{i}.png"))
    assert Image.open(osp.join(dirs["port"][0], "0.png")).size == (24, 20)
    lab = np.asarray(Image.open(osp.join(dirs["port"][1], "0.png")))
    assert lab.shape == ((20, 24) if with_labels else (40, 50))


def test_make_lp_images_matches_jax(tmp_path, monkeypatch, capsys):
    """From the same PB_FCN and LabelProp checkpoints (the JAX package's
    checkpoint.save, perturbed BN statistics): the port's label maps and
    PNGs equal the JAX tool's on >= 0.999 of the pixels."""
    root = str(tmp_path / "robocup")
    make_lp_tree(root, size=(60, 80), n_seq=2, seq_len=3, seed=6)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(7)
    for name, model in (("pth/bestModelSeg.pth",
                         jzoo.make("pb_fcn", planes=32, num_classes=5,
                                   kernel_size=1)),
                        ("pth/bestModelLP.pth",
                         jzoo.make("label_prop", num_classes=5, planes=32))):
        params = {k: np.array(v) for k, v in
                  model.init(jax.random.PRNGKey(1)).items()}
        for k in params:
            if k.endswith(".running_mean"):
                params[k] = rng.standard_normal(params[k].shape).astype(np.float32)
            elif k.endswith(".running_var"):
                params[k] = (0.05 + 0.05 * rng.random(params[k].shape)).astype(np.float32)
        jcheckpoint.save(name, model.registry, params)
    assert jmake_lp_images.main(["--root", root, "--out", "jax"]) == 0
    assert make_lp_images.main(["--root", root, "--out", "port"],
                               device="cpu") == 0
    assert "wrote 4 (seg, lp) pairs to port" in capsys.readouterr().out
    for i in range(4):
        for kind in ("seg", "lp"):
            got, want = (np.asarray(Image.open(f"{d}/{i}_{kind}.png"))
                         for d in ("port", "jax"))
            assert got.shape == want.shape == (120, 160, 3)
            assert np.mean(np.any(got != want, axis=-1)) <= 1e-3, (i, kind)
            assert len(np.unique(got.reshape(-1, 3), axis=0)) > 1
    shutil.rmtree("port")
