"""A pool of CPU processes in one gloo process group, for the port's mesh
tests (tests/test_torch_mesh*.py), and the jobs they run there.

The processes are spawned (never forked: the test process has JAX
running), join a group over 127.0.0.1 on a free port, and then run the
jobs they are handed, all together, each as one rank. A job is a
function of this module (which imports no JAX), called on every rank
with the same arguments; the pool returns each rank's result in rank
order, or fails with every rank's traceback. Every wait has a timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

JOB_TIMEOUT = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, jobs, results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        results.put((rank, True, None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            name, args = job
            try:
                results.put((rank, True, globals()[name](*args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """``world`` ranks of a gloo group; ``run(job, *args)`` runs the job of
    this module named ``job`` on every rank."""

    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world = world
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, port, self.jobs[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._collect(JOB_TIMEOUT)

    def _collect(self, timeout: float):
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < self.world:
            try:
                rank, ok, value = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(
                        f"the pool's ranks did not answer (exited: {dead}, "
                        f"after at most {timeout} s); answered: "
                        f"{sorted(got)}; errors: {errors}")
                continue
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError("\n".join(errors))
        return [got[r] for r in range(self.world)]

    def run(self, job: str, *args, timeout: float = JOB_TIMEOUT):
        for q in self.jobs:
            q.put((job, args))
        return self._collect(timeout)

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# ---- jobs (each runs on every rank) --------------------------------------------


def _mesh(spatial=1):
    from robocupvision_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(spatial=spatial, device="cpu")


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def mesh_shapes(spatials):
    """Each mesh's shape and this rank's coordinates; the refusals."""
    from robocupvision_tpu_torch.parallel.mesh import make_mesh

    out = [(m.shape, m.coords, m.is_main)
           for m in (make_mesh(spatial=s, device="cpu") for s in spatials)]
    errors = []
    for n, s in ((None, 3), (8, 1)):
        try:
            make_mesh(n, spatial=s, device="cpu")
            errors.append(None)
        except (AssertionError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    return out, errors


def shard_batch_errors(spatial, imgs_shape, batch):
    """The two ValueErrors of ``shard_batch``, and a block it cuts."""
    from robocupvision_tpu_torch.parallel.mesh import shard_batch

    mesh = _mesh(spatial)
    msgs = []
    imgs = torch.zeros(imgs_shape)
    tgt = torch.zeros(imgs_shape[:3], dtype=torch.int64)
    try:
        shard_batch(mesh, imgs, tgt, torch.ones(imgs_shape[0]))
    except ValueError as e:
        msgs.append(str(e))
    flat = _mesh(1)
    try:
        shard_batch(flat, torch.zeros((batch,) + imgs_shape[1:]),
                    torch.zeros((batch,) + imgs_shape[1:3]),
                    torch.ones(batch), spatial=False)
    except ValueError as e:
        msgs.append(str(e))
    x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8, 1, 1)
    i, t, m = shard_batch(mesh, x, x[..., 0], torch.arange(8.0))
    return msgs, (i.numpy(), t.numpy(), m.numpy())


def collectives(x_global, g_global, halos):
    """``all_reduce_sum`` and ``halo_exchange`` on a 1 x world spatial
    mesh: forward values and the gradient of a weighted sum of each."""
    from robocupvision_tpu_torch.parallel.mesh import local_rows

    mesh = _mesh(dist.get_world_size())
    r, s = mesh.spatial_index, mesh.shape["spatial"]
    x = local_rows(torch.from_numpy(x_global), s, r).clone() \
        .requires_grad_(True)
    w = torch.from_numpy(g_global)[r]
    y = mesh.all_reduce_sum(x * w.sum())
    (gy,) = torch.autograd.grad((y * w.sum()).sum(), [x])
    out = {"sum": y.detach().numpy(), "sum_grad": gy.numpy(), "halo": []}
    for top, bottom in halos:
        e = mesh.halo_exchange(x, top, bottom)
        ge = torch.from_numpy(g_global)[r, :, :e.shape[1]]
        (gx,) = torch.autograd.grad((e * ge).sum(), [x])
        out["halo"].append((e.detach().numpy(), gx.numpy()))
    return out


def train_step(spatial, model_kw, cfg_kw, params, imgs, targets, mask,
               prune_masks, lr, steps=1):
    """``steps`` SGD steps of the mesh's train step on this rank's block
    of the global batch (full height; the step cuts its rows): the new
    params and the metrics."""
    from robocupvision_tpu_torch.data.device_cache import shard_rows
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import optim, step as tstep

    mesh = _mesh(spatial)
    model = zoo.make("robo_unet", device="cpu", **model_kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    tx = optim.sgd(momentum=0.5)
    step = tstep.make_train_step(model, tx, tstep.StepCfg(**cfg_kw),
                                 mesh=mesh)
    state = tstep.init_state(model, tx)
    masks = None if prune_masks is None else \
        {k: torch.from_numpy(v) for k, v in prune_masks.items()}
    rows = [shard_rows(mesh, torch.from_numpy(a)) for a in (imgs, targets)]
    m = shard_rows(mesh, torch.from_numpy(mask), fill=0.0)
    outs = []
    for _ in range(steps):
        state, out = step(state, *rows, m, None, lr, masks)
        outs.append({k: float(v) for k, v in out.items()})
    return _np(state.params), outs


def losses_shares(spatial, logits, targets, mask, weights):
    """This rank's ce2d and dice shares on its block of the batch, and
    the gradients of their sum w.r.t. its logits."""
    from robocupvision_tpu_torch.ops import losses
    from robocupvision_tpu_torch.parallel.mesh import shard_batch

    mesh = _mesh(spatial)
    lg, tg, m = shard_batch(mesh, torch.from_numpy(logits),
                            torch.from_numpy(targets), torch.from_numpy(mask))
    lg = lg.clone().requires_grad_(True)
    pm = m.reshape(-1, 1, 1) * torch.ones(tg.shape)
    w = torch.tensor(weights)
    ce = losses.cross_entropy_2d(lg, tg, w, pm, mesh=mesh)
    dice = losses.dice_loss(lg, tg, w, pm, mesh=mesh)
    (g,) = torch.autograd.grad(ce + dice, [lg])
    return float(ce.detach()), float(dice.detach()), g.numpy()


def packed_serving(model_kw, params, x, int8):
    """The flagship's chain graph served data-parallel: this rank's block
    of the frames through ``PackedInfer`` (K2's plain version on the
    CPU), the labels gathered; and the one-process labels."""
    from robocupvision_tpu_torch.models import packed, zoo
    from robocupvision_tpu_torch.parallel.mesh import batch_sharding

    mesh = _mesh(1)
    model = zoo.make("robo_unet", device="cpu", **model_kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    pi = packed.build_packed_infer(model, dtype=torch.float32, pallas=True,
                                   device="cpu")
    xs = torch.from_numpy(x)
    if int8:
        pi = packed.quantize_int8(pi, xs)
    sh = batch_sharding(mesh, None)
    local = pi.infer(sh.local(xs))
    return sh.gather(local).numpy(), pi.infer(xs).numpy(), local.shape[0]


class IdDataset:
    """n items; item i is an image filled with i and the label i."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.float32), np.int32(i)


class ArrayDataset:
    def __init__(self, imgs, labels):
        self.imgs, self.labels = imgs, labels

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], self.labels[i]


def _trainer(spatial, model_kw, cfg_kw, params, train, val, batch, seed=5):
    from robocupvision_tpu_torch.data.device_cache import DeviceCache
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import optim, step as tstep
    from robocupvision_tpu_torch.train.loop import Trainer

    mesh = None if spatial is None else _mesh(spatial)
    model = zoo.make("robo_unet", device="cpu", **model_kw)
    caches = [None if a is None else DeviceCache.from_numpy(*a, device="cpu")
              for a in (train, val)]
    tr = Trainer(model, optim.sgd(momentum=0.5), tstep.StepCfg(**cfg_kw),
                 *caches, batch, seed=seed, mesh=mesh)
    tr.set_params({k: torch.from_numpy(v) for k, v in params.items()})
    return tr


def trainer_run(spatial, model_kw, cfg_kw, params, train, val, batch, perms,
                lr):
    """``len(perms)`` train epochs (the permutations given) and a
    validation of a Trainer on a mesh of ``spatial`` (None: no mesh):
    the epoch losses, the validation metrics, the params."""
    tr = _trainer(spatial, model_kw, cfg_kw, params, train, val, batch)
    it = iter(perms)
    tr.draw_perm = lambda n: torch.from_numpy(np.array(next(it)))
    losses = [tr.train_epoch(lr).loss for _ in perms]
    val = {k: v for k, v in tr.valid_epoch().items() if k != "conf"}
    return losses, val, tr.params_numpy()


def trainer_stream(spatial, model_kw, cfg_kw, params, train, batch, lr,
                   epochs):
    """Streamed epochs (host shuffle, the step's augmentation) of a Trainer
    on a mesh of ``spatial`` (None: no mesh): losses and params."""
    tr = _trainer(spatial, model_kw, cfg_kw, params, None, None, batch)
    ds = ArrayDataset(*train)
    losses = [tr.train_epoch_streamed(lr, ds).loss for _ in range(epochs)]
    return losses, tr.params_numpy()


def stream_partition(n, batch):
    """A sharded stream's real ids and batch count on this rank, and the
    refusals of explicit process arguments that disagree with the mesh."""
    from robocupvision_tpu_torch.data.streaming import StreamingBatches
    from robocupvision_tpu_torch.parallel.mesh import sample_sharding

    mesh = _mesh(1)
    sh = sample_sharding(mesh)
    stream = StreamingBatches(IdDataset(n), batch, np.random.default_rng(7),
                              sharding=sh)
    batches = list(stream)
    ids = [int(l) for _, labs, m in batches
           for l, mm in zip(labs.numpy(), m.numpy()) if mm > 0]
    errors = []
    for kw in (dict(process_index=1 - mesh.data_index),
               dict(process_count=3)):
        try:
            StreamingBatches(IdDataset(n), batch, sharding=sh, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return ids, len(batches), len(stream), str(batches[0][0].device), errors


def train_cli(workdir, argv):
    """train.py's main in ``workdir`` on the CPU: rc and what it printed."""
    import contextlib
    import io
    import os

    from robocupvision_tpu_torch.cli import train

    cwd = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(workdir)
        with contextlib.redirect_stdout(out):
            rc = train.main(argv, device="cpu")
    finally:
        os.chdir(cwd)
    return rc, out.getvalue()
