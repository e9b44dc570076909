"""The port's deployment read side against the JAX package's, with weights
carried through export/torch_io.py: ``weights_io.load_params_flat`` (f4 and
f8 streams, exactly), ``deploy.verify_deployment`` (the cfg interpreter
against the live model, within 1e-4) and its interpreter output against
the JAX interpreter's on the same export (1e-5), the native engine against
the port's ``run_cfg`` (rtol = atol = 1e-4: the engine contracts with
FMA), and ``cli/verifyDeploy.py``'s verdicts, at the small widths of
tests/test_native_engine.py."""

import os

import numpy as np
import pytest

import jax
import torch

from robocupvision_tpu.cli import verifyDeploy as jverify
from robocupvision_tpu.export import netcfg as jnetcfg
from robocupvision_tpu.export import weights_io as jweights_io
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu_torch.cli import verifyDeploy
from robocupvision_tpu_torch.export import (deploy, netcfg, torch_io,
                                            weights_io)
from robocupvision_tpu_torch.export.engine import NativeEngine
from robocupvision_tpu_torch.models import zoo

NETS = [
    ("pb_fcn", dict(planes=8, num_classes=5), 3),
    ("label_prop", dict(planes=8), 8),
    ("robo_unet", dict(planes=4, depth=3, levels=1, belly_size=2,
                       belly_planes=8), 3),
    ("robo_unet", dict(planes=4, depth=3, levels=1, belly_size=2,
                       belly_planes=8, v2=True, class_size=3), 3),
    ("robo_unet", dict(planes=4, depth=3, levels=2, belly_size=2,
                       belly_planes=8, pool=True), 3),
]
_IDS = ["pb_fcn", "label_prop", "robo_unet", "robo_unet_v2", "robo_unet_pool"]


def _carried(family, kw, seed=7):
    """JAX params (BN statistics perturbed) and the port's model holding
    them through the carry."""
    jm = jzoo.make(family, **kw)
    rng = np.random.default_rng(seed)
    jp = {k: np.array(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    for k in jp:
        if k.endswith(".running_mean"):
            jp[k] = rng.standard_normal(jp[k].shape).astype(np.float32) * 0.3
        elif k.endswith(".running_var"):
            jp[k] = (0.5 + rng.random(jp[k].shape)).astype(np.float32)
    model = zoo.make(family, device="cpu", **kw)
    model.load_state_dict(torch_io.from_jax_params(model.registry, jp))
    return jm, jp, model


def _x(in_ch, seed=5, hw=(48, 64)):
    return np.random.default_rng(seed).standard_normal(
        (1, *hw, in_ch)).astype(np.float32)


@pytest.mark.parametrize("family,kw,in_ch", NETS, ids=_IDS)
def test_verify_deployment_and_engine(tmp_path, family, kw, in_ch):
    jm, jp, model = _carried(family, kw)
    d = str(tmp_path / family)
    deploy.export_deployment(d, model)
    x = _x(in_ch)
    diff = deploy.verify_deployment(d, model, None, x)
    assert 0 <= diff <= 1e-4
    # given params (not the module's own) are what is compared
    assert deploy.verify_deployment(d, zoo.make(family, device="cpu", **kw),
                                    model.state_dict(), x) == diff
    secs = netcfg.parse_cfg(os.path.join(d, "net.cfg"))
    flat = np.fromfile(os.path.join(d, "weights.dat"), dtype="<f4")
    got = netcfg.run_cfg(secs, flat, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnetcfg.run_cfg(secs, flat, x)),
                               rtol=0, atol=1e-5)
    eng = NativeEngine(os.path.join(d, "net.cfg"), os.path.join(d, "weights.dat"))
    assert eng.weights_fully_consumed
    out = eng.forward(np.ascontiguousarray(np.transpose(x[0], (2, 0, 1))))
    np.testing.assert_allclose(out, np.transpose(got[0], (2, 0, 1)),
                               rtol=1e-4, atol=1e-4)
    eng.close()


def test_verify_deployment_catches_a_wrong_pair(tmp_path):
    _, _, model = _carried("label_prop", dict(planes=8))
    d = str(tmp_path / "lp")
    deploy.export_deployment(d, model)
    other = zoo.make("label_prop", planes=8, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    with pytest.raises(AssertionError, match="deployment mismatch"):
        deploy.verify_deployment(d, other, None, _x(8))


def test_engine_rejects_truncated_weights(tmp_path):
    _, _, model = _carried("label_prop", dict(planes=8))
    d = str(tmp_path / "lp")
    deploy.export_deployment(d, model)
    w = os.path.join(d, "weights.dat")
    flat = np.fromfile(w, dtype="<f4")
    flat[: flat.size // 2].tofile(w)
    with pytest.raises(RuntimeError):
        NativeEngine(os.path.join(d, "net.cfg"), w)


@pytest.mark.parametrize("width", ["<f4", "<f8"])
@pytest.mark.parametrize("family,kw,skip_classifier",
                         [("label_prop", dict(planes=8), False),
                          ("pb_fcn", dict(planes=8), True),
                          ("robo_unet", dict(planes=4, depth=3, levels=1,
                                             belly_size=2, belly_planes=8),
                           False)])
def test_load_params_flat_matches_jax(tmp_path, width, family, kw,
                                      skip_classifier):
    """Both element widths (the reference's own dumps are float64), and
    ``skip_classifier`` (left-out tensors come back as zeros): the port's
    state_dict carried to JAX layouts equals the JAX loader's, exactly."""
    jm, jp, model = _carried(family, kw, seed=11)
    path = weights_io.save_params(str(tmp_path), model.registry,
                                  model.state_dict(),
                                  skip_classifier=skip_classifier)
    if width == "<f8":
        np.fromfile(path, "<f4").astype("<f8").tofile(path)
    got = weights_io.load_params_flat(path, model.registry,
                                      skip_classifier=skip_classifier)
    want = jweights_io.load_params_flat(path, jm.registry,
                                        skip_classifier=skip_classifier)
    assert list(got) == list(model.registry.specs)
    back = torch_io.to_jax_params(model.registry, got)
    assert list(back) == list(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    for k, v in got.items():
        assert tuple(v.shape) == model.registry.specs[k].torch_shape
        if skip_classifier and "classifier" in k:
            assert not v.any()
        else:
            assert torch.equal(v, model.state_dict()[k])


def test_load_params_flat_refuses_a_stream_of_another_length(tmp_path):
    model = zoo.make("label_prop", planes=8, device="cpu")
    path = weights_io.save_params(str(tmp_path), model.registry,
                                  model.state_dict())
    flat = np.fromfile(path, "<f4")
    np.concatenate([flat, flat[:3]]).tofile(path)
    with pytest.raises(ValueError, match=f"consumed {flat.size} of "
                                         f"{flat.size + 3} floats"):
        weights_io.load_params_flat(path, model.registry)


def _cli(main, args, capsys, **kw):
    rc = main(args, **kw)
    return rc, capsys.readouterr().out


def test_verify_deploy_cli_matches_jax(tmp_path, capsys):
    """A good directory: rc 0 and OK, checkpoint comparison included; the
    same directory with its weights cut: rc 1 and FAIL, as the JAX CLI."""
    from robocupvision_tpu_torch.train import checkpoint

    _, _, model = _carried("pb_fcn", dict(planes=8, num_classes=5))
    d = str(tmp_path / "weights")
    deploy.export_deployment(d, model)
    ckpt = str(tmp_path / "seg.pth")
    checkpoint.save(ckpt, model.registry, model.state_dict())
    args = ["--dir", d, "--planes", "8"]
    rc, out = _cli(verifyDeploy.main, args + ["--checkpoint", ckpt], capsys,
                   device="cpu")
    assert rc == 0 and out.splitlines()[-1] == "OK", out
    assert "label agreement=1.000000" in out
    assert "artifacts vs live model: max|diff|=" in out
    jrc, jout = _cli(jverify.main, args + ["--checkpoint", ckpt], capsys)
    assert jrc == rc and jout.splitlines()[-1] == "OK"
    w = os.path.join(d, "weights.dat")
    flat = np.fromfile(w, dtype="<f4")
    flat[: flat.size // 2].tofile(w)
    for main, kw in ((verifyDeploy.main, dict(device="cpu")),
                     (jverify.main, {})):
        rc, out = _cli(main, args, capsys, **kw)
        assert rc == 1 and out.splitlines()[-1].startswith("FAIL"), out
    rc, out = _cli(verifyDeploy.main, ["--dir", str(tmp_path / "none")],
                   capsys, device="cpu")
    assert rc == -1 and "missing net.cfg" in out
