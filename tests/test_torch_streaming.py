"""The port's streamed input pipeline (data/streaming.py) and
``Trainer.train_epoch_streamed`` against the JAX package's, on the CPU.

``StreamingBatches`` yields the JAX stream's batches and masks for the
same numpy generator, its per-process strided shards and their padding
included; a dataset error is raised at the epoch's end and not after an
early break; the producer stops when the consumer leaves. An unshuffled
streamed epoch equals the cached epoch with the same draws, exactly; a
shuffled one, with the JAX Trainer's augmentation draws injected, ends
where the JAX Trainer's streamed epoch ends (loss within 1e-4 relative,
parameters within 1e-4). chip_smoke.py's ``train_streamed`` holds the
card's copies from pinned memory on the side stream to the cached epoch."""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robocupvision_tpu.data.streaming import StreamingBatches as JStreaming
from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.train import loop as jloop
from robocupvision_tpu.train import optim as joptim
from robocupvision_tpu.train import step as jstep
from robocupvision_tpu_torch.data.device_cache import (DeviceCache,
                                                       epoch_batches)
from robocupvision_tpu_torch.data.streaming import StreamingBatches
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import zoo
from robocupvision_tpu_torch.train import loop, optim
from robocupvision_tpu_torch.train import step as tstep

H, W = 24, 32
KW = dict(planes=4, depth=3, levels=1, belly_size=2, belly_planes=8)


class IdDataset:
    """Each image holds its own index; labels are uint8 maps."""

    def __init__(self, n, hw=(2, 2)):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full(self.hw + (3,), i, np.float32),
                np.full(self.hw, i % 5, np.uint8))


class ArrayDataset:
    def __init__(self, imgs, labs, fail_at=None):
        self.imgs, self.labs, self.fail_at = imgs, labs, fail_at

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise IOError(f"unreadable sample {i}")
        return self.imgs[i], self.labs[i]


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n, H, W, 3)).astype(np.float32)
    labs = rng.integers(0, 5, (n, H, W)).astype(np.int32)
    return imgs, labs


def _as_numpy(batches):
    return [tuple(np.asarray(a) for a in b) for b in batches]


@pytest.mark.parametrize("n,bs,pi,pc,seed", [
    (12, 5, 0, 1, 0),        # a padded last batch
    (10, 5, 0, 1, None),     # no shuffle, no padding
    (23, 4, 0, 3, 7), (23, 4, 1, 3, 7), (23, 4, 2, 3, 7),  # strided shards
    (9, 4, 0, 2, 7), (9, 4, 1, 2, 7),     # shards straddling a batch
    (2, 4, 1, 3, 3),         # an empty shard: one all-padding batch
])
def test_batches_match_jax(n, bs, pi, pc, seed):
    ds = IdDataset(n)
    rng = (lambda: None) if seed is None \
        else (lambda: np.random.default_rng(seed))
    want = _as_numpy(JStreaming(ds, bs, rng(), process_index=pi,
                                process_count=pc))
    stream = StreamingBatches(ds, bs, rng(), process_index=pi,
                              process_count=pc, device="cpu")
    got = _as_numpy(stream)
    assert len(got) == len(want) == len(stream)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_process_shards_partition_the_epoch():
    n, seen, counts = 23, [], []
    for pi in range(3):
        ids, nb = [], 0
        for imgs, _, mask in StreamingBatches(IdDataset(n), 4,
                                              np.random.default_rng(7),
                                              process_index=pi,
                                              process_count=3, device="cpu"):
            nb += 1
            ids.extend(int(v) for v, m in zip(imgs[:, 0, 0, 0], mask) if m)
        assert len(ids) == len(range(pi, n, 3))
        seen.append(set(ids))
        counts.append(nb)
    assert seen[0] | seen[1] | seen[2] == set(range(n))
    assert not (seen[0] & seen[1] or seen[0] & seen[2] or seen[1] & seen[2])
    assert len(set(counts)) == 1


def test_device_transform_runs_after_the_copy():
    seen = []

    def transform(imgs, labs):
        seen.append((imgs.dtype, imgs.device.type))
        return imgs.float() / 255.0, labs.long()

    ds = ArrayDataset(np.full((5, 2, 2, 3), 255, np.uint8),
                      np.ones((5, 2, 2), np.uint8))
    out = list(StreamingBatches(ds, 2, device_transform=transform,
                                device="cpu"))
    assert seen == [(torch.uint8, "cpu")] * 3
    imgs, labs, mask = out[-1]
    assert imgs.dtype == torch.float32 and labs.dtype == torch.int64
    assert torch.equal(mask, torch.tensor([1.0, 0.0]))
    assert float(imgs[0].min()) == 1.0 and float(imgs[1].max()) == 0.0


def test_dataset_error_raised_at_the_epoch_end():
    imgs, labs = _frames(9)
    stream = StreamingBatches(ArrayDataset(imgs, labs, fail_at=6), 3,
                              device="cpu")
    got = []
    with pytest.raises(IOError, match="sample 6"):
        for b in stream:
            got.append(b)
    assert len(got) == 2  # the batches before the failing one


def test_early_break_stops_the_producer_and_raises_nothing():
    imgs, labs = _frames(40)
    before = threading.active_count()
    stream = StreamingBatches(ArrayDataset(imgs, labs, fail_at=30), 2,
                              prefetch=1, device="cpu")
    for i, _ in enumerate(stream):
        if i == 1:
            break
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_concurrent_streams_under_a_short_switch_interval():
    """More streams (each with its producer thread) than cores, the
    interpreter switching threads every 10 µs: each consumer gets its
    whole epoch, in order, with no batch lost or repeated."""
    import os
    import sys

    n_streams = 2 * (os.cpu_count() or 4)
    got, errors = {}, []

    def consume(k):
        try:
            got[k] = [int(v) for imgs, _, mask in StreamingBatches(
                IdDataset(37), 4, np.random.default_rng(k), prefetch=1,
                device="cpu") for v, m in zip(imgs[:, 0, 0, 0], mask) if m]
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    for k in range(n_streams):
        assert got[k] == list(np.random.default_rng(k).permutation(37)), k


# ---- Trainer.train_epoch_streamed --------------------------------------------


def _trainers(imgs, labs, bs, seed=0):
    jm = jzoo.make("robo_unet", **KW)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = zoo.make("robo_unet", device="cpu", **KW)
    tm.load_state_dict(torch_io.from_jax_params(tm.registry, jp))
    cfg = dict(num_classes=5, class_weights=(1, 10, 30, 10, 2),
               l1_decay=1e-6, out_size=1.0 / (H * W))
    cache = DeviceCache.from_numpy(imgs, labs, device="cpu")
    ttr = loop.Trainer(tm, optim.adam(), tstep.StepCfg(**cfg), cache, None,
                       bs)
    ttr.init()
    return jm, jp, ttr, cfg


def test_unshuffled_streamed_epoch_equals_cached_epoch():
    """The same batches (the stream pads with zeros, the cache with sample
    0: both masked out) and the same draws give the same params."""
    imgs, labs = _frames(11, seed=1)
    _, _, tr, _ = _trainers(imgs, labs, 4)
    p0 = {k: v.clone() for k, v in tr.state.params.items()}
    g0 = tr.gen.get_state()
    res = tr.train_epoch_streamed(1e-3, ArrayDataset(imgs, labs),
                                  shuffle=False)
    assert np.isfinite(res.loss)
    streamed = {k: v.clone() for k, v in tr.state.params.items()}

    tr.set_params(p0)
    tr.gen.set_state(g0)
    tot = tr._steps(epoch_batches(tr.train_cache, 4), 1e-3, None)
    cached = tr._epoch_result(tot, 3)
    for k, v in streamed.items():
        torch.testing.assert_close(v, tr.state.params[k], rtol=0, atol=0,
                                   msg=k)
    assert res == cached


def test_shuffled_streamed_epoch_matches_jax():
    """Both Trainers' streamed epochs shuffle with a numpy generator seeded
    with the Trainer's seed; the port gets the JAX step's augmentation
    draws. Two epochs, so the second order comes from the same generator
    continued."""
    imgs, labs = _frames(10, seed=2)
    jm, jp, ttr, cfg = _trainers(imgs, labs, 4, seed=3)
    seed = 99
    jtr = jloop.Trainer(jm, joptim.adam(), jstep.StepCfg(**cfg), None, None,
                        4, seed=seed, scan_epochs=False)
    jtr.set_params({k: np.asarray(v) for k, v in jp.items()})
    ttr.seed = seed
    key = jax.random.PRNGKey(seed)

    def draws(n):
        nonlocal key
        key, sub = jax.random.split(key)
        aug_rng, _ = jax.random.split(sub)
        vals = []
        for k in jax.random.split(aug_rng, n):
            kf, kj = jax.random.split(k)
            kb, kc, ks, kh = jax.random.split(kj, 4)
            h = 3.1415 / 6
            vals.append((bool(jax.random.uniform(kf, ()) > 0.5),
                         *(float(jax.random.uniform(kk, (), minval=lo,
                                                    maxval=hi))
                           for kk, lo, hi in ((kb, -0.3, 0.3),
                                              (kc, 0.7, 1.3),
                                              (ks, 0.7, 1.3),
                                              (kh, -h, h)))))
        flip, b, c, s, hh = zip(*vals)
        return {"flip": torch.tensor(flip),
                **{k: torch.tensor(v, dtype=torch.float32)
                   for k, v in zip("bcsh", (b, c, s, hh))}}

    ttr.draw_augment = draws
    ds = ArrayDataset(imgs, labs)
    for lr in (1e-3, 5e-4):
        jres = jtr.train_epoch_streamed(lr, ds)
        tres = ttr.train_epoch_streamed(lr, ds)
        assert tres.loss == pytest.approx(jres.loss, rel=1e-4)
        assert tres.reg == pytest.approx(jres.reg, rel=1e-4)
    want = torch_io.from_jax_params(ttr.model.registry,
                                    jtr.params_numpy())
    for k, v in want.items():
        np.testing.assert_allclose(ttr.state.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_streamed_epoch_takes_uint8_frames_and_a_transform():
    imgs, labs = _frames(7, seed=4)
    u8 = np.clip(imgs * 40 + 128, 0, 255).astype(np.uint8)
    _, _, tr, _ = _trainers(imgs, labs, 4)

    def normalize(x, y):
        return (x.float() - 128.0) / 40.0, y.long()

    res = tr.train_epoch_streamed(1e-3, ArrayDataset(u8, labs.astype(np.uint8)),
                                  device_transform=normalize)
    assert np.isfinite(res.loss) and res.pixel_acc > 0
