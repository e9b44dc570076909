"""The port's cfg interpreter and golden-vector dumper against the JAX
package's: ``netcfg.run_cfg`` on every ``testDumper.CASES`` entry within
atol 1e-5 of the JAX interpreter (float reassociation of the convs and
sums); the four ``nn`` ops it added (avg_pool, pixel_shuffle, linear,
softmax) against the JAX ones; and ``cli/testDumper.py``: inputs, weights
and cfgs byte-identical to the JAX dumper's, outputs within 1e-5, and the
native C++ engine replaying them at tests/test_golden_dumper.py's rtol
1e-4 / atol 1e-5 (the engine contracts with FMA)."""

import os
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robocupvision_tpu.cli import testDumper as jdumper
from robocupvision_tpu.export import netcfg as jnetcfg
from robocupvision_tpu.ops import nn as jnn
from robocupvision_tpu_torch.cli import testDumper
from robocupvision_tpu_torch.export import netcfg
from robocupvision_tpu_torch.export.engine import NativeEngine
from robocupvision_tpu_torch.ops import nn


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", jdumper.CASES, ids=lambda c: c[0])
def test_run_cfg_matches_jax(case):
    name, layer_secs, (h, w, cin) = case
    sections = [("net", dict(height=h, width=w, channels=cin, downscale=1))]
    sections += layer_secs
    flat = jdumper._weights_for(sections, cin, np.random.default_rng(
        zlib.crc32(name.encode())))
    x = _rand((1, 1, 1, 32) if name == "FC" else (1, h, w, cin), 3)
    want, want_all = jnetcfg.run_cfg(sections, flat, x, return_all=True)
    got, got_all = netcfg.run_cfg(sections, flat, torch.from_numpy(x),
                                  return_all=True)
    assert len(got_all) == len(want_all)
    for g, wnt in zip(got_all, want_all):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-5)
    assert got.dtype == torch.float32 and got.shape == np.asarray(want).shape


@pytest.mark.parametrize("op", ["avg_pool", "pixel_shuffle", "linear",
                                "softmax"])
def test_new_nn_ops_match_jax(op):
    x = _rand((2, 6, 10, 8), 4)
    if op == "avg_pool":
        got = nn.avg_pool(torch.from_numpy(x), 2, 2)
        want = jnn.avg_pool(jnp.asarray(x), 2, 2)
        got3 = nn.avg_pool(torch.from_numpy(x), (3, 2), (2, 3))
        np.testing.assert_allclose(got3.numpy(), np.asarray(
            jnn.avg_pool(jnp.asarray(x), (3, 2), (2, 3))), atol=1e-6)
    elif op == "pixel_shuffle":
        got = nn.pixel_shuffle(torch.from_numpy(x), 2)
        want = jnn.pixel_shuffle(jnp.asarray(x), 2)
        # torch.nn.PixelShuffle on the NCHW view
        ref = torch.nn.PixelShuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert torch.equal(got, ref.permute(0, 2, 3, 1))
    elif op == "linear":
        xl, wl, bl = _rand((5, 8), 5), _rand((8, 3), 6), _rand((3,), 7)
        got = nn.linear(torch.from_numpy(xl), torch.from_numpy(wl),
                        torch.from_numpy(bl))
        want = jnn.linear(jnp.asarray(xl), jnp.asarray(wl), jnp.asarray(bl))
        assert nn.linear(torch.from_numpy(xl), torch.from_numpy(wl)).shape \
            == (5, 3)
    else:
        got = nn.softmax(torch.from_numpy(x), dim=-1)
        want = jnn.softmax(jnp.asarray(x), axis=-1)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_test_dumper_matches_jax_and_engine_replays(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    assert jdumper.main(["--out", "jax"]) == 0
    assert testDumper.main(["--out", "port"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "TrC" in out and "wrote golden vectors for 22 layer configs" in out
    assert testDumper.CASES == jdumper.CASES
    assert sorted(os.listdir("port")) == sorted(os.listdir("jax"))
    for f in ("dataC1.npy", "dataF.npy"):
        assert _read(f"port/{f}") == _read(f"jax/{f}"), f
    data_c1 = np.fromfile("port/dataC1.npy", np.float32).reshape(4, 32, 32)
    data_f = np.fromfile("port/dataF.npy", np.float32).reshape(32, 1, 1)
    for name, _, _ in testDumper.CASES:
        for f in (f"{name}.cfg", f"{name}.npy"):
            assert _read(f"port/{f}") == _read(f"jax/{f}"), f
        got = np.fromfile(f"port/out{name}.npy", np.float32)
        want = np.fromfile(f"jax/out{name}.npy", np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        eng = NativeEngine(f"port/{name}.cfg", f"port/{name}.npy")
        replay = eng.forward(data_f if name == "FC" else data_c1).reshape(-1)
        np.testing.assert_allclose(replay, got, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        eng.close()


def test_flat_reader_and_unknown_section():
    r = netcfg.FlatReader(np.arange(10, dtype=np.float64))
    assert r.take(2, 3).shape == (2, 3) and r.take(4).dtype == np.float32
    assert r.done()
    with pytest.raises(ValueError, match="unknown section"):
        netcfg.run_cfg([("net", {}), ("dropout", {})], np.zeros(0),
                       torch.zeros(1, 2, 2, 1))
    with pytest.raises(ValueError, match="inputs=5"):
        netcfg.run_cfg([("net", {}), ("connected", dict(outputs=2, inputs=5))],
                       np.zeros(100), torch.zeros(1, 1, 1, 4))
