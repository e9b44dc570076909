"""The port's deployment export (robocupvision_tpu_torch.export: netcfg,
weights_io, deploy) against the JAX package's: for carried params, the
net.cfg text and the weights.dat bytes are identical, for LabelProp (the
weightsLP export validLabelProp.py writes on every run), PB_FCN (the
tester's weights/ and weightsVGA/) and ROBO-UNet. BN running statistics
are perturbed so that every tensor of the stream differs from its init."""

import os

import numpy as np
import pytest

import jax
import torch

from robocupvision_tpu.export import deploy as jdeploy
from robocupvision_tpu.export import netcfg as jnetcfg
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.export import deploy, netcfg, torch_io, weights_io
from robocupvision_tpu_torch.models import zoo as tzoo

CASES = [("label_prop", dict()), ("label_prop", dict(planes=8)),
         ("pb_fcn", dict()), ("pb_fcn", dict(no_scale=True, kernel_size=3)),
         ("robo_unet", dict()), ("robo_unet", dict(no_scale=True, levels=1))]


def _carried(family, kw, seed):
    jm = jzoo.make(family, **kw)
    rng = np.random.default_rng(seed)
    jp = {k: np.array(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    for k in jp:
        if k.endswith(".running_mean"):
            jp[k] = rng.standard_normal(jp[k].shape).astype(np.float32) * 0.3
        elif k.endswith(".running_var"):
            jp[k] = (0.5 + rng.random(jp[k].shape)).astype(np.float32)
    model = tzoo.make(family, device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    return jm, jp, model


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("family,kw", CASES)
def test_export_deployment_matches_jax(tmp_path, family, kw):
    jm, jp, model = _carried(family, kw, 5)
    jdeploy.export_deployment(str(tmp_path / "jax"), jm, jp)
    assert deploy.export_deployment(str(tmp_path / "port"), model) \
        == str(tmp_path / "port")
    for name in ("net.cfg", "weights.dat"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name), name
    secs = netcfg.parse_cfg(str(tmp_path / "port" / "net.cfg"))
    assert secs == jnetcfg.parse_cfg(str(tmp_path / "jax" / "net.cfg"))
    assert secs[0][0] == "net" and secs[-1][0] == "softmax"


def test_label_prop_weights_size():
    """LabelProp(planes=32)'s stream: 92,837 float32 values, the parameter
    count of the reference's shipped weightsLP/weights.dat."""
    model = tzoo.make("label_prop", device="cpu")
    n = sum(int(np.prod(s.shape)) for s in model.registry.specs.values())
    assert n == 92837


def test_save_params_skips(tmp_path):
    """``skip_prefixes`` leaves out a head precisely: PB_FCN's
    ``segmenter.classifier`` stays, its classification head goes."""
    model = tzoo.make("pb_fcn", device="cpu")
    reg, sd = model.registry, model.state_dict()
    sizes = {k: v.numel() for k, v in sd.items()}
    out = weights_io.save_params(str(tmp_path), reg, sd,
                                 skip_prefixes=("classifier.",))
    assert out == str(tmp_path / "weights.dat")
    assert os.path.getsize(out) == 4 * sum(
        n for k, n in sizes.items() if not k.startswith("classifier."))
    assert any("segmenter.classifier" in k for k in sizes)
    flat = np.fromfile(out, "<f4")
    np.testing.assert_array_equal(flat[:sizes["FCN.conv0.conv.weight"]],
                                  sd["FCN.conv0.conv.weight"].numpy().ravel())


def test_apply_param_widths_reads_the_kernels():
    """Section widths come from the state's kernels (conv: dim 0, tconv:
    dim 1 in torch layout), so a narrower layer rewrites its section."""
    model = tzoo.make("label_prop", device="cpu")
    sd = dict(model.state_dict())
    secs = netcfg.label_prop_sections()
    assert netcfg.apply_param_widths(secs, model.registry, sd) == secs
    sd["pre.conv.weight"] = torch.zeros(6, 8, 3, 3)
    sd["upConv3.conv.weight"] = torch.zeros(16, 12, 3, 3)
    got = netcfg.apply_param_widths(secs, model.registry, sd)
    assert got[1][1]["filters"] == 6 and got[-5][1]["filters"] == 12
    with pytest.raises(ValueError):
        netcfg.apply_param_widths(secs[:-3], model.registry, sd)


def test_export_refuses_what_has_no_graph(tmp_path):
    with pytest.raises(ValueError):
        deploy.export_deployment(str(tmp_path),
                                 tzoo.make("pb_fcn", classify=True, device="cpu"))
    with pytest.raises(ValueError):
        deploy.export_deployment(str(tmp_path),
                                 tzoo.make("pb_fcn_2", device="cpu"))


@pytest.mark.parametrize("family,kw,skip_classifier",
                         [("pb_fcn_2", dict(), True),
                          ("pb_fcn_2", dict(), False),
                          ("pb_fcn", dict(), True)])
def test_save_params_knobs_match_jax(tmp_path, capsys, family, kw,
                                     skip_classifier):
    """The knobs the JAX tester's ``--dump`` uses: ``fname`` (weights2.dat
    unless ``--pruned``) and ``skip_classifier``, the reference's substring
    test, with which it dumps ``--v2`` (PB_FCN_2); the port's bytes equal
    the JAX package's for carried params."""
    from robocupvision_tpu.export import weights_io as jweights_io

    jm, jp, model = _carried(family, kw, 9)
    jout = jweights_io.save_params(str(tmp_path / "jax"), jm.registry, jp,
                                   fname="weights2.dat",
                                   skip_classifier=skip_classifier)
    out = weights_io.save_params(str(tmp_path / "port"), model.registry,
                                 model.state_dict(), fname="weights2.dat",
                                 skip_classifier=skip_classifier)
    assert out == str(tmp_path / "port" / "weights2.dat")
    assert _read(out) == _read(jout)
    printed = capsys.readouterr().out
    assert ("Classifier module skipped" in printed) == skip_classifier


@pytest.mark.parametrize("fname", ["weights.dat", "weights2.dat"])
def test_export_deployment_params_and_fname_match_jax(tmp_path, fname):
    """``export_deployment`` of given params (not the module's own) under
    the tester's file names, byte for byte the JAX package's."""
    jm, jp, model = _carried("pb_fcn", dict(no_scale=True), 6)
    other = tzoo.make("pb_fcn", device="cpu", no_scale=True)  # other weights
    jdeploy.export_deployment(str(tmp_path / "jax"), jm, jp, fname=fname)
    deploy.export_deployment(str(tmp_path / "port"), other,
                             model.state_dict(), fname=fname)
    for name in ("net.cfg", fname):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name), name
