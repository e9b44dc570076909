"""The port's structured pruning (robocupvision_tpu_torch/ops/slim.py) and
the slim dicts through its width-driven consumers, against the JAX
package's (tests/test_slim.py), on the CPU at small widths, on the same
seeded params carried through export/torch_io.py.

Tolerances: the groups, ``prune_channels``' masks (in the JAX layout) and
``prune_topk``'s masks identical; ``compact``'s arrays bit-identical; the
analytic op counts equal; slim forwards within rtol = atol = 1e-5; slim
packed and chain graphs within rtol = atol = 2e-4 with equal labels; int8
labels of the slim chain graph in >= 0.999 agreement with the JAX
package's quantized graph (f32, as tests/test_torch_int8.py holds it) and
>= 0.95 with float (bf16); the AOT artifact equal
to the live graph; the deployment within 1e-4; slim checkpoints read by
either package from the other's file."""

import os.path as osp
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from test_slim import FAMS, ROBO_VARIANTS  # noqa: E402

from robocupvision_tpu.models import packed as jpacked  # noqa: E402
from robocupvision_tpu.models import zoo as jzoo  # noqa: E402
from robocupvision_tpu.ops import pruning as jpruning  # noqa: E402
from robocupvision_tpu.ops import slim as jslim  # noqa: E402
from robocupvision_tpu.train import checkpoint as jckpt  # noqa: E402
from robocupvision_tpu_torch.export import torch_io  # noqa: E402
from robocupvision_tpu_torch.models import packed as tpacked  # noqa: E402
from robocupvision_tpu_torch.models import zoo as tzoo  # noqa: E402
from robocupvision_tpu_torch.ops import pruning as tpruning  # noqa: E402
from robocupvision_tpu_torch.ops import slim as tslim  # noqa: E402
from robocupvision_tpu_torch.train import checkpoint as tckpt  # noqa: E402

_NETS = {**{f"robo_unet_{v}": ("robo_unet", kw, (1, 32, 32, 3))
            for v, kw in ROBO_VARIANTS.items()},
         **{f: (f, kw, xs) for f, (kw, xs) in FAMS.items()
            if f != "robo_unet"},
         "pb_fcn_2_levels3": ("pb_fcn_2", dict(planes=8, depth=4, levels=3,
                                               belly_size=3, belly_planes=16),
                              (1, 32, 32, 3))}
_CACHE = {}


def _net(name, seed=0):
    """(JAX model, JAX params, port model, port params) on the same seeded
    weights, once a module."""
    if (name, seed) not in _CACHE:
        fam, kw, _ = _NETS[name]
        jm = jzoo.make(fam, **kw)
        jp = {k: np.asarray(v)
              for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
        tm = tzoo.make(fam, device="cpu", **kw)
        tp = torch_io.from_jax_params(tm.registry, jp)
        tm.load_state_dict(tp)
        _CACHE[name, seed] = (jm, jp, tm, tp)
    return _CACHE[name, seed]


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jx(params):
    return {k: jnp.asarray(np.asarray(v)) for k, v in params.items()}


def _slim(name, ratio=0.4, round_to=1, min_keep=1):
    """Both packages' (masked, masks, slim) of one net, and the port's
    slim dict carried to the JAX layout."""
    jm, jp, tm, tp = _net(name)
    jmasked, jmasks = jslim.prune_channels(jp, jslim.channel_groups(jm),
                                           ratio, min_keep=min_keep,
                                           round_to=round_to, verbose=False)
    tmasked, tmasks = tslim.prune_channels(tp, tslim.channel_groups(tm),
                                           ratio, min_keep=min_keep,
                                           round_to=round_to, verbose=False)
    jsl, jkept = jslim.compact(jm, jmasked, min_keep=min_keep)
    tsl, tkept = tslim.compact(tm, tmasked, min_keep=min_keep)
    return dict(jmasked=jmasked, jmasks=jmasks, jslim=jsl, jkept=jkept,
                tmasked=tmasked, tmasks=tmasks, tslim=tsl, tkept=tkept,
                carried=torch_io.to_jax_params(tm.registry, tsl, slim=True))


@pytest.mark.parametrize("name", list(_NETS))
def test_groups_validate_and_match_jax(name):
    jm, jp, tm, tp = _net(name)
    tslim.validate_groups(tm, tp)
    jg, tg = jslim.channel_groups(jm), tslim.channel_groups(tm)
    assert [(g.size, [(o.conv, o.bias, o.bn, o.start) for o in g.outs],
             [(i.conv, i.start) for i in g.ins]) for g in jg] == \
        [(g.size, [(o.conv, o.bias, o.bn, o.start) for o in g.outs],
          [(i.conv, i.start) for i in g.ins]) for g in tg]
    for g in tg:  # every slice carries its kernel's kind, hence its axis
        for s in g.outs + g.ins:
            assert s.kind == tm.registry.specs[s.conv].kind


def test_validate_groups_catches_a_wrong_width():
    _, _, tm, tp = _net("robo_unet_flagship")
    bad = dict(tp)
    name = "downPart.Level1.layers.Conv0.conv.weight"
    bad[name] = bad[name][:-1]
    with pytest.raises(ValueError):
        tslim.validate_groups(tm, bad)


@pytest.mark.parametrize("name", list(_NETS))
def test_masks_compact_and_forward_match_jax(name):
    """prune_channels' masks equal the JAX package's after the layout
    transpose, compact's arrays equal bit for bit, the kept counts equal,
    and the masked and slim forwards agree with each other and with the
    JAX package's slim forward."""
    fam, _, xs = _NETS[name]
    jm, _, tm, tp = _net(name)
    r = _slim(name, ratio=0.35 if fam != "robo_unet" else 0.4)
    assert set(r["jmasks"]) == set(r["tmasks"])
    for k, m in r["jmasks"].items():
        got = torch_io.to_jax_layout(r["tmasks"][k].numpy(),
                                     tm.registry.specs[k].kind)
        np.testing.assert_array_equal(got, m, err_msg=k)
    assert r["tkept"] == r["jkept"]
    for k, v in r["jslim"].items():
        assert r["carried"][k].shape == v.shape, k
        np.testing.assert_array_equal(r["carried"][k], v, err_msg=k)
    assert tslim.param_count(r["tslim"]) < tslim.param_count(tp)
    assert tslim.param_count(r["tslim"]) == jslim.param_count(r["jslim"])

    x = _x((2,) + xs[1:])
    a = tm.apply(r["tmasked"], torch.from_numpy(x))
    b = tm.apply(r["tslim"], torch.from_numpy(x))
    want, _ = jm.apply(_jx(r["jslim"]), jnp.asarray(x), train=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_pb_fcn_classify_head_stays_loadable():
    """One slim PB_FCN dict serves the classify head too."""
    kw = dict(planes=16, classify=True)
    jm = jzoo.make("pb_fcn", **kw)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    tm = tzoo.make("pb_fcn", device="cpu", **kw)
    tp = torch_io.from_jax_params(tm.registry, jp)
    masked, _ = tslim.prune_channels(tp, tslim.channel_groups(tm), 0.3,
                                     verbose=False)
    sl, _ = tslim.compact(tm, masked)
    x = _x((1, 32, 32, 3))
    a = tm.apply(masked, torch.from_numpy(x))
    b = tm.apply(sl, torch.from_numpy(x))
    jsl = torch_io.to_jax_params(tm.registry, sl, slim=True)
    want, _ = jm.apply(_jx(jsl), jnp.asarray(x), train=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_train_mode_masked_equals_compacted():
    """Exact in train mode too (batch-statistic BN): a dead channel stays
    zero through BN since gamma == beta == 0; the new running statistics
    of the kept channels match the JAX package's."""
    jm, _, tm, _ = _net("robo_unet_flagship")
    r = _slim("robo_unet_flagship")
    x = _x((2, 32, 32, 3))
    a, mut_a = tm.apply(r["tmasked"], torch.from_numpy(x), train=True)
    b, mut_b = tm.apply(r["tslim"], torch.from_numpy(x), train=True)
    want, jmut = jm.apply(_jx(r["jslim"]), jnp.asarray(x), train=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert set(mut_a) == set(mut_b) == set(jmut)
    for k in jmut:
        np.testing.assert_allclose(mut_b[k].numpy(), np.asarray(jmut[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_masked_adam_step_keeps_channels_dead_and_compacts_exactly():
    """One Adam step of the port's train step under the structured masks
    leaves the pruned positions exactly zero, so compaction stays exact on
    the stepped params."""
    from robocupvision_tpu_torch.models.layers import split_params
    from robocupvision_tpu_torch.train import optim, step as tstep

    _, _, tm, _ = _net("robo_unet_flagship")
    r = _slim("robo_unet_flagship")
    cfg = tstep.StepCfg(num_classes=5, class_weights=(1.,) * 5,
                        augment=False, out_size=1.0 / (32 * 32))
    tx = optim.adam()
    params = {k: v.clone() for k, v in r["tmasked"].items()}
    state = tstep.TrainState(params, tx.init(split_params(params)[0]))
    x = torch.from_numpy(_x((2, 32, 32, 3)))
    y = torch.from_numpy(np.random.default_rng(3).integers(0, 5, (2, 32, 32)))
    state, _ = tstep.make_train_step(tm, tx, cfg)(
        state, x, y, torch.ones(2), None, 1e-2, r["tmasks"])
    stepped = {k: v.detach() for k, v in state.params.items()}
    moved = 0
    for name, mk in r["tmasks"].items():
        assert not stepped[name][mk].any(), name
        moved += int((stepped[name] != r["tmasked"][name]).sum())
    assert moved > 0
    sl, _ = tslim.compact(tm, stepped)
    assert tslim.param_count(sl) == tslim.param_count(r["tslim"])
    np.testing.assert_allclose(tm.apply(stepped, x).numpy(),
                               tm.apply(sl, x).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("round_to,min_keep", [(4, 4), (8, 8), (1, 3)])
def test_round_to_and_min_keep(round_to, min_keep):
    _, _, tm, _ = _net("robo_unet_flagship")
    r = _slim("robo_unet_flagship", ratio=0.9, round_to=round_to,
              min_keep=min_keep)
    assert r["tkept"] == r["jkept"]
    for g, n in zip(tslim.channel_groups(tm), r["tkept"].values()):
        assert n == g.size or (n >= min_keep and n % round_to == 0), \
            (n, g.size)
    for k, v in r["jslim"].items():
        np.testing.assert_array_equal(r["carried"][k], v, err_msg=k)


def test_compact_noop_on_dense_params():
    _, _, tm, tp = _net("robo_unet_flagship")
    sl, kept = tslim.compact(tm, tp)
    assert tslim.param_count(sl) == tslim.param_count(tp)
    for k in tp:
        assert torch.equal(sl[k], tp[k]), k
    x = torch.from_numpy(_x((1, 32, 32, 3)))
    assert torch.equal(tm.apply(tp, x), tm.apply(sl, x))  # a true no-op


def test_prune_topk_matches_jax():
    """pruner.py's top-k pruning: identical masks and params (ties fall
    where the JAX package's argpartition puts them: a tensor with repeated
    magnitudes), at every size class."""
    jm, jp, tm, tp = _net("pb_fcn")
    jp = dict(jp)
    name = "FCN.conv4.conv.weight"
    jp[name] = np.round(jp[name] * 64) / 64  # many equal |w|
    tp = torch_io.from_jax_params(tm.registry, jp)
    before = {k: v.clone() for k, v in tp.items()}
    for low_t, high_t in ((500, 15000), (1000, 50000), (10 ** 6, 10 ** 7)):
        jn, jmk = jpruning.prune_topk(jp, jm.param_order, 0.16, low_t, high_t,
                                      verbose=False)
        tn, tmk = tpruning.prune_topk(tp, tm.registry, 0.16, low_t, high_t,
                                      verbose=False)
        assert set(jmk) == set(tmk)
        for k, m in jmk.items():
            kind = tm.registry.specs[k].kind
            np.testing.assert_array_equal(
                torch_io.to_jax_layout(tmk[k].numpy(), kind), m, err_msg=k)
            np.testing.assert_array_equal(
                torch_io.to_jax_layout(tn[k].numpy(), kind), jn[k], err_msg=k)
    for k in tp:  # the input is not written
        assert torch.equal(tp[k], before[k]), k


@pytest.mark.parametrize("variant,forms", [
    ("flagship", [dict(), dict(pallas=True),
                  dict(pallas=True, pallas_fold_stem=True, pallas_deep=True)]),
    ("v2", [dict(), dict(pallas=True),
            dict(pallas=True, pallas_fold_stem=True, pallas_deep=True)]),
    ("unet", [dict(), dict(pallas=True),
              dict(pallas=True, pallas_fold_stem=True)]),
    ("noscale", [dict()])])
def test_packed_and_chain_graphs_on_slim_params(variant, forms):
    """The packed graphs build from a slim dict (widths from the arrays),
    plain and as chain graphs (chain_reference on the CPU), and match the
    slim zoo apply and the JAX package's packed graph on the same slim
    dict: logits within 2e-4, labels equal; the JAX chain graph (interpret
    mode) labels equal too."""
    name = f"robo_unet_{variant}"
    jm, _, tm, _ = _net(name)
    r = _slim(name)
    x = _x((1, 32, 32, 3))
    want = tm.apply(r["tslim"], torch.from_numpy(x)).numpy()
    jx = _jx(r["carried"])
    jbase = jpacked.build_packed_infer(jm, jx, dtype=jnp.float32)
    jlogits = np.asarray(jbase.logits(jnp.asarray(x)))
    jlabels = np.asarray(jbase.infer(jnp.asarray(x)))
    np.testing.assert_allclose(jlogits, want, atol=2e-4, rtol=2e-4)
    for kw in forms:
        pi = tpacked.build_packed_infer(tm, r["tslim"], torch.float32,
                                        device="cpu", **kw)
        got = pi.logits(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got, jlogits, atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(pi.infer(torch.from_numpy(x)).numpy(),
                                      jlabels)
    if variant == "flagship":
        jchain = jpacked.build_packed_infer(jm, jx, dtype=jnp.float32,
                                            pallas=True,
                                            pallas_interpret=True)
        np.testing.assert_array_equal(np.asarray(jchain.infer(
            jnp.asarray(x))), jlabels)


def test_int8_quantization_on_slim_chains():
    """Static int8 of the slim chain graph: in f32, labels agree with the
    JAX package's quantized slim graph (its chains through its plain
    reference, as tests/test_torch_int8.py runs them); in bf16, the
    serving dtype, with the float slim graph, and infer is the argmax of
    the quantized logits."""
    import dataclasses

    jm, _, tm, _ = _net("robo_unet_flagship")
    r = _slim("robo_unet_flagship")
    x = _x((1, 32, 32, 3))
    tx = torch.from_numpy(x)
    f32 = tpacked.build_packed_infer(tm, r["tslim"], torch.float32,
                                     pallas=True, device="cpu")
    jf = jpacked.build_packed_infer(jm, _jx(r["carried"]), dtype=jnp.float32,
                                    pallas=True, pallas_interpret=True)
    jq = jpacked.quantize_int8(jf, jnp.asarray(x))
    jref = dataclasses.replace(jq, chains={**jq.chains, "collect": {}})
    agree_jax = float(np.mean(tpacked.quantize_int8(f32, tx).infer(tx).numpy()
                              == np.asarray(jref.infer(jnp.asarray(x)))))
    assert agree_jax >= 0.999, agree_jax
    f = tpacked.build_packed_infer(tm, r["tslim"], torch.bfloat16,
                                   pallas=True, device="cpu")
    q = tpacked.quantize_int8(f, tx)
    labels = q.infer(tx)
    agree = float(np.mean(labels.numpy() == f.infer(tx).numpy()))
    assert agree >= 0.95, agree
    assert torch.equal(labels.long(),
                       torch.argmax(q.logits(tx).float(), dim=-1))


def test_get_computations_shape_driven_for_slim():
    """The analytic op counts read widths from the compacted shapes, equal
    to the JAX package's: slim < masked (nnz ratio) < dense."""
    jm, jp, tm, tp = _net("robo_unet_flagship")
    dense = sum(tzoo.robo_unet_get_computations(tm.cfg))
    assert sum(tzoo.robo_unet_get_computations(tm.cfg, tp, pruned=True)) \
        == pytest.approx(dense, rel=1e-6)
    r = _slim("robo_unet_flagship", ratio=0.5)
    masked = tzoo.robo_unet_get_computations(tm.cfg, r["tmasked"], pruned=True)
    slim_c = tzoo.robo_unet_get_computations(tm.cfg, r["tslim"], pruned=True)
    assert slim_c == jzoo.robo_unet_get_computations(jm.cfg, r["jslim"],
                                                     pruned=True)
    assert masked == pytest.approx(jzoo.robo_unet_get_computations(
        jm.cfg, r["jmasked"], pruned=True), rel=1e-6)
    assert sum(slim_c) < sum(masked) < dense


def test_aot_export_on_slim_params(tmp_path):
    """A slim dict exports as a serving.pt2 (plain and chain graphs) that
    reloads and labels as the live slim graph does."""
    from robocupvision_tpu_torch.export import aot

    _, _, tm, _ = _net("robo_unet_flagship")
    r = _slim("robo_unet_flagship")
    x = torch.from_numpy(_x((1, 32, 32, 3)))
    for pallas in (False, True):
        out = aot.export_serving(str(tmp_path), tm, r["tslim"], hw=(32, 32),
                                 dtype=torch.float32, pallas=pallas,
                                 platforms=("cpu",), fname=f"s{pallas}.pt2")
        live = tpacked.build_packed_infer(tm, r["tslim"], torch.float32,
                                          pallas=pallas, device="cpu")
        assert torch.equal(aot.load_serving(out)(x), live.infer_u8(x))


@pytest.mark.parametrize("name", ["robo_unet_flagship", "pb_fcn",
                                  "label_prop"])
def test_slim_deploy_export_interpreter_and_engine(tmp_path, name):
    """A slim dict exports to net.cfg (per-layer widths from the params) +
    weights.dat equal to the JAX package's export of the same slim dict;
    the cfg interpreter matches the slim zoo apply, and the native engine
    the interpreter."""
    from robocupvision_tpu.export import deploy as jdeploy
    from robocupvision_tpu_torch.export import deploy, netcfg
    from robocupvision_tpu_torch.export.engine import NativeEngine

    _, _, xs = _NETS[name]
    jm, _, tm, _ = _net(name)
    r = _slim(name)
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    deploy.export_deployment(d, tm, r["tslim"])
    jdeploy.export_deployment(jd, jm, r["jslim"])
    for f in ("net.cfg", "weights.dat"):
        with open(osp.join(d, f), "rb") as a, open(osp.join(jd, f), "rb") as b:
            assert a.read() == b.read(), f
    x = _x((1, 32, 32, xs[-1]), seed=2)
    assert deploy.verify_deployment(d, tm, r["tslim"], x) <= 1e-4
    secs = netcfg.parse_cfg(osp.join(d, "net.cfg"))
    flat = np.fromfile(osp.join(d, "weights.dat"), dtype="<f4")
    got = netcfg.run_cfg(secs, flat, torch.from_numpy(x)).numpy()
    eng = NativeEngine(osp.join(d, "net.cfg"), osp.join(d, "weights.dat"))
    try:
        assert eng.weights_fully_consumed
        out = eng.forward(np.ascontiguousarray(x[0].transpose(2, 0, 1)))
    finally:
        eng.close()
    np.testing.assert_allclose(out, got[0].transpose(2, 0, 1), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_slim_checkpoint_round_trip_both_ways(tmp_path, writer):
    """Either package reads the other's slim file (the slim marker lifts
    the shape guard); an unmarked file of slim shapes keeps the strict
    guard in both."""
    jm, _, tm, _ = _net("robo_unet_flagship")
    r = _slim("robo_unet_flagship")
    path = str(tmp_path / "slim.weights.slim")
    if writer == "port":
        tckpt.save(path, tm.registry, r["tslim"], slim=True)
    else:
        jckpt.save(path, jm.registry, r["jslim"], slim=True)
    back = tckpt.load_any(path, tm.registry)
    jback = jckpt.load_any(path, jm.registry)
    for k in r["tslim"]:
        assert torch.equal(back[k], r["tslim"][k]), k
        np.testing.assert_array_equal(jback[k], r["jslim"][k], err_msg=k)
    unmarked = str(tmp_path / "broken.weights")
    if writer == "port":  # the port writes no unmarked file of slim shapes
        with pytest.raises(ValueError):
            tckpt.save(unmarked, tm.registry, r["tslim"])
    jckpt.save(unmarked, jm.registry, r["jslim"])
    with pytest.raises(ValueError):
        tckpt.load_any(unmarked, tm.registry)
    with pytest.raises(ValueError):
        jckpt.load_any(unmarked, jm.registry)
