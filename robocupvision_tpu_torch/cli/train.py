"""Segmentation training CLI, the reference's ``python train.py`` (the JAX
package's cli/train.py; reference train.py:205-389).

The same flags, prints and checkpoint names: the transfer sweep (10x LR on
the first N encoder levels) and the finetune decay sweep, Adam with a
per-epoch cosine LR, the L1 term, best-model selection on (mean class
accuracy + mean IoU) / 2, ``--bf16``, ``--labSize``, ``--chunkEpochs``,
``--resume`` with its markers, and ``--finetune``'s load and its
prune-and-finetune phase: the reference's unstructured pruning, or with
``--pruneStruct R`` whole channel groups (ops/slim.py), finetuned under
their masks and compacted into a ``.slim`` sibling checkpoint. The dataset
is decoded once and kept on the device; each (transfer, decay)
combination runs in :func:`train_combo`, which takes the train and val
``DeviceCache``.

    python -m robocupvision_tpu_torch.cli.train --root $DATA

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.

In a process group of more than one rank (``torchrun --standalone
--nproc-per-node N -m robocupvision_tpu_torch.cli.train ...``, or a group
the caller set up), or with ``--spatial S``, training runs on
``parallel.mesh.make_mesh(spatial=S)``: data-parallel over N / S ranks,
each image's rows split over S. Rank 0 alone prints and writes the
checkpoints and resume markers; one process with ``--spatial > 1`` fails
the mesh's precondition (the world size must be a multiple of S).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, no_tf32, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ROBO-UNet segmentation training")
    p.add_argument("--finetune", help="Finetuning", action="store_true", default=False)
    p.add_argument("--v2", help="Use v2 architecture", action="store_true", default=False)
    p.add_argument("--noScale", help="Use VGA resolution", action="store_true", default=False)
    p.add_argument("--UNet", help="Use Vanilla U-Net", action="store_true", default=False)
    p.add_argument("--useDice", help="Use Dice Loss", action="store_true", default=False)
    p.add_argument("--noBall", help="Treat Ball as Background", action="store_true")
    p.add_argument("--noGoal", help="Treat Goal as Background", action="store_true")
    p.add_argument("--noRobot", help="Treat Robot as Background", action="store_true")
    p.add_argument("--noLine", help="Treat Lines as Background", action="store_true")
    p.add_argument("--topCam", help="Use Top Camera images only", action="store_true")
    p.add_argument("--bottomCam", help="Use Bottom Camera images only", action="store_true")
    p.add_argument("--lr", help="Learning rate", type=float, default=1e-3)
    p.add_argument("--decay", help="Weight decay", type=float, default=1e-5)
    p.add_argument("--transfer", help="Layers to truly train", action="store_true")
    p.add_argument("--root", help="Dataset root", type=str,
                   default=os.environ.get("ROBOCUP_DATA", "../../Data/RoboCup"))
    p.add_argument("--epochs", help="Override epoch count", type=int, default=None)
    p.add_argument("--batchSize", help="Override batch size", type=int, default=None)
    p.add_argument("--spatial", help="Spatial mesh axis size (image-height "
                   "sharding)", type=int, default=1)
    p.add_argument("--bf16", help="bfloat16 compute (f32 master weights)",
                   action="store_true", default=False)
    p.add_argument("--labSize", help="Override working resolution H W "
                   "(testing aid; the reference sizes are the default)",
                   type=int, nargs=2, default=None)
    p.add_argument("--chunkEpochs", help="Epochs between metric fetches: "
                   "prints stream and the best checkpoint is written after "
                   "every chunk; 0 = one chunk for the whole run", type=int,
                   default=25)
    p.add_argument("--resume", help="Write a per-chunk resume snapshot "
                   "(params + optimizer + best + generator) and, if one "
                   "exists, continue the killed run from it",
                   action="store_true", default=False)
    p.add_argument("--pruneStruct", help="Structured pruning ratio of the "
                   "post-finetune phase (0 = the reference's unstructured "
                   "pruning): whole channel groups are zeroed, finetuned "
                   "under their masks and compacted into a .slim sibling "
                   "checkpoint", type=float, default=0.0)
    p.add_argument("--slimRound", help="--pruneStruct: round kept widths up "
                   "to a multiple", type=int, default=8)
    p.add_argument("--slimMinKeep", help="--pruneStruct: minimum kept "
                   "channels per group", type=int, default=8)
    return p


def model_hyper(unet: bool, v2: bool) -> dict:
    """The ROBO-UNet hyperparameters of the reference's train.py:302-307
    table (``--UNet``, ``--v2`` or the flagship); the ``pool``/``v2`` flags
    themselves are the caller's."""
    num_planes = 8
    levels = 3 if unet else (1 if v2 else 2)
    depth = 4
    belly_size = 0 if unet else (9 if v2 else 5)
    class_size = 3 if v2 else 1
    belly_planes = num_planes * 2 ** (depth - 1) if v2 else num_planes * 2 ** depth
    return dict(planes=num_planes, levels=levels, depth=depth,
                belly_size=belly_size, class_size=class_size,
                belly_planes=belly_planes)


@dataclasses.dataclass(frozen=True)
class Setup:
    """What the flags fix for every combination of a sweep."""
    opt: argparse.Namespace
    flags: object               # naming.Flags
    lab_size: Tuple[int, int]
    out_size: float
    epochs: int
    batch_size: int
    class_weights: Tuple[float, ...]
    mask_flags: Tuple[bool, bool, bool, bool]

    @classmethod
    def from_opt(cls, opt: argparse.Namespace) -> "Setup":
        from robocupvision_tpu_torch.train import naming

        flags = naming.Flags(finetune=opt.finetune, v2=opt.v2,
                             no_scale=opt.noScale, unet=opt.UNet,
                             no_ball=opt.noBall, no_goal=opt.noGoal,
                             no_robot=opt.noRobot, no_line=opt.noLine,
                             top_cam=opt.topCam, bottom_cam=opt.bottomCam)
        scale = 2 if opt.noScale else 4
        lab_size = tuple(opt.labSize) if opt.labSize \
            else (480 // scale, 640 // scale)
        # class-weight table (train.py:309-313)
        weights = [1, 2, 6, 3, 2] if opt.useDice else [1, 10, 30, 10, 2]
        if opt.finetune:
            weights = [1, 6, 2, 10, 4]
        keep = [True, not opt.noBall, not opt.noRobot, not opt.noGoal,
                not opt.noLine]
        return cls(
            opt=opt, flags=flags, lab_size=lab_size,
            out_size=1.0 / (lab_size[0] * lab_size[1]),
            epochs=opt.epochs if opt.epochs is not None
            else (200 if opt.finetune else 100),
            batch_size=opt.batchSize if opt.batchSize is not None
            else (16 if opt.finetune else (32 if opt.noScale else 64)),
            class_weights=tuple(w for w, k in zip(weights, keep) if k),
            mask_flags=(opt.noBall, opt.noRobot, opt.noGoal, opt.noLine))


def step_cfg(s: Setup, l1_decay: float):
    """The step configuration of the flags, with this L1 term."""
    from robocupvision_tpu_torch.train.step import StepCfg

    return StepCfg(num_classes=s.flags.num_classes,
                   loss="dice" if s.opt.useDice else "ce2d",
                   class_weights=s.class_weights, l1_decay=l1_decay,
                   mask_flags=s.mask_flags, out_size=s.out_size,
                   compute_dtype="bfloat16" if s.opt.bf16 else "float32")


def train_combo(s: Setup, train_cache, val_cache, transfer: int,
                decay: float, device: DeviceLike = None,
                marker: Optional[str] = None, main_done: bool = False,
                after_chunk: Optional[Callable[[int, dict], None]] = None,
                mesh=None) -> Optional[float]:
    """One (transfer, decay) combination of the sweep on the two caches:
    the main training run (unless ``main_done``), its checkpoint, and for
    ``--finetune`` at transfer 0 the prune-and-finetune phase (structured
    with ``--pruneStruct``). ``marker``:
    the ``--resume`` marker written once the main phase is durable.
    ``after_chunk(epoch_offset, metrics)`` is called after each chunk's
    prints. ``mesh``: both phases train on it, and only its rank 0 writes
    files. Returns the main run's best score (None when ``main_done``)."""
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import pruning as prune_ops
    from robocupvision_tpu_torch.ops import slim as slim_ops
    from robocupvision_tpu_torch.train import checkpoint, naming, optim
    from robocupvision_tpu_torch.train.loop import Trainer
    from robocupvision_tpu_torch.train.schedules import CosineAnnealingLR

    opt = s.opt
    dev = resolve_device(device)
    writes = mesh is None or mesh.is_main
    no_tf32()  # without --bf16 the convs and matmuls train in f32
    epochs = s.epochs
    learning_rate = opt.lr
    path = naming.train_ckpt_name(s.flags, transfer)
    model = zoo.make("robo_unet", no_scale=opt.noScale,
                     num_classes=s.flags.num_classes, pool=opt.UNet,
                     v2=opt.v2, device=dev,
                     generator=torch.Generator().manual_seed(12345678),
                     **model_hyper(opt.UNet, opt.v2))
    comp = zoo.robo_unet_get_computations(model.cfg)
    print([round(c) for c in comp])
    print(round(sum(comp)))
    chunk_epochs = opt.chunkEpochs or None

    best_loss = None
    if not main_done:
        tr = Trainer(model, optim.adam(), step_cfg(s, decay), train_cache,
                     val_cache, s.batch_size,
                     multipliers=optim.transfer_multipliers(
                         model.param_order, transfer), mesh=mesh)
        tr.init()
        if opt.finetune:
            load_path = naming.train_load_name(s.flags)
            print(f"Loading {load_path}")
            tr.set_params(checkpoint.load_any(load_path, model.registry))

        eta_min = learning_rate / 25 if opt.transfer else learning_rate / 10
        sched = CosineAnnealingLR([learning_rate], epochs, eta_min)
        lrs = []
        for _ in range(epochs):
            lrs.append(sched.get_lr()[0])
            sched.step()

        def on_chunk(off, ms, chunk_best):
            for i in range(len(ms["better"])):
                epoch = off + i
                lr = lrs[epoch]
                print("[Epoch Train %d/%d lr: %.4f][Losses: reg %f, "
                      "pruned %f, total %f][Pixel Acc: %f]"
                      % (epoch + 1, epochs, lr / learning_rate,
                         ms["train_reg"][i], ms["pruned"][i],
                         ms["train_loss"][i], ms["train_pixel_acc"][i]))
                print("[Epoch Val %d/%d lr: %.4f][Losses: total %f]"
                      "[Pixel Acc: %f, Mean Class Acc: %f, Mean IoU: %f]"
                      % (epoch + 1, epochs, lr / learning_rate,
                         ms["val_loss"][i], ms["pixel_acc"][i],
                         ms["mean_class_acc"][i], ms["mean_iou"][i]))
                if ms["better"][i]:
                    print("Saving best model")
                    print(np.array_str(ms["conf"][i], precision=2,
                                       suppress_small=True))
            if chunk_best is not None and writes:
                checkpoint.save(path, model.registry, chunk_best)
            if after_chunk is not None:
                after_chunk(off, ms)

        resume_path = f"{path}.resume-T{transfer}-{decay:g}.npz" \
            if marker is not None else None
        best_loss, best_params, ms = tr.train_run(
            epochs, lrs, chunk_epochs=chunk_epochs, on_chunk=on_chunk,
            resume_path=resume_path)
        if writes and resume_path is not None and os.path.exists(resume_path):
            os.remove(resume_path)  # run completed; snapshot obsolete
        if best_params is not None and writes:
            checkpoint.save(path, model.registry, best_params)
        if marker is not None and writes:
            # the main phase is durable: a restart during the prune phase
            # must not train it again
            with open(marker, "w") as f:
                f.write(f"main {float(best_loss)!r}")

    # post-finetune pruning phase (train.py:375-388)
    if opt.finetune and transfer == 0:
        if mesh is not None:
            mesh.barrier()  # rank 0 has written the best checkpoint
        best_path = naming.train_ckpt_name(s.flags, 0)
        params = checkpoint.load_any(best_path, model.registry)
        structured = opt.pruneStruct > 0
        if structured:
            params, masks = slim_ops.prune_channels(
                params, slim_ops.channel_groups(model), opt.pruneStruct,
                min_keep=opt.slimMinKeep, round_to=opt.slimRound)
        else:
            params, masks = prune_ops.prune_threshold(params,
                                                      model.param_order)
        tr = Trainer(model, optim.adam(), step_cfg(s, 0.0), train_cache,
                     val_cache, s.batch_size, mesh=mesh)
        tr.set_params(params)
        print("Finetuning")

        def on_prune_chunk(off, ms, chunk_best):
            for i in range(len(ms["better"])):
                epoch = off + i
                print("[Epoch Train %d/25][pruned %f, total %f]"
                      "[Pixel Acc: %f]"
                      % (epoch + 1, ms["pruned"][i], ms["train_loss"][i],
                         ms["train_pixel_acc"][i]))
                print("[Epoch Val %d/25][total %f][Pixel Acc: %f, "
                      "Mean Class Acc: %f, Mean IoU: %f]"
                      % (epoch + 1, ms["val_loss"][i], ms["pixel_acc"][i],
                         ms["mean_class_acc"][i], ms["mean_iou"][i]))
                if ms["better"][i]:
                    print("Saving best model")

        # the snapshot's name carries the mode: a snapshot of the other
        # mode must never resume into this one (its params do not keep
        # this mode's masks, and compact would then find nothing to remove)
        mode = "pruneS" if structured else "prune"
        prune_resume = f"{path}.resume-{mode}-{decay:g}.npz" \
            if marker is not None else None
        # near-zero weights zeroed barely move the function: lr/20
        # (reference train.py:377); a structured cut removes whole
        # channels, and recovering needs the finetune's own lr
        lr_ft = learning_rate if structured else learning_rate / 20
        _, best_params, ms = tr.train_run(
            25, [lr_ft] * 25, prune_masks=masks,
            chunk_epochs=chunk_epochs, on_chunk=on_prune_chunk,
            resume_path=prune_resume)
        if writes and prune_resume is not None \
                and os.path.exists(prune_resume):
            os.remove(prune_resume)
        if best_params is not None and writes:
            if len(ms) and np.any(ms["better"]):
                # the share of the epoch that produced best_params: the file
                # name is an API (train/naming.py)
                best_epoch = int(np.nonzero(ms["better"])[0][-1])
                prune_pct = round(float(ms["pruned"][best_epoch]) * 100)
            else:
                prune_pct = round(100.0 * prune_ops.count_zero_weights(
                    best_params, model.param_order))
            bp = {k: torch.from_numpy(v) for k, v in best_params.items()}
            mflops = round(sum(zoo.robo_unet_get_computations(
                model.cfg, bp, pruned=True)) / 1e6)
            pruned_path = naming.train_ckpt_name(s.flags, 0, pruned=True,
                                                 prune_pct=prune_pct,
                                                 mflops=mflops)
            checkpoint.save(pruned_path, model.registry, bp)
            if structured:
                # the structurally dead channels compacted away: a slim
                # sibling with real per-layer width cuts
                slim_params, _ = slim_ops.compact(model, bp)
                slim_path = pruned_path + ".slim"
                checkpoint.save(slim_path, model.registry, slim_params,
                                slim=True)
                n0 = slim_ops.param_count(bp)
                n1 = slim_ops.param_count(slim_params)
                print("Compacted %s: %d -> %d params (%.1f%% fewer)"
                      % (slim_path, n0, n1, 100.0 * (1 - n1 / n0)))
    return best_loss


def _world() -> int:
    """The ranks of the process group (or of torchrun's environment)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None, device: DeviceLike = None) -> int:
    opt = build_parser().parse_args(argv)
    s = Setup.from_opt(opt)
    if s.flags.num_classes <= 1:
        print("You need to have at least one non-background class!")
        return -1
    mesh = None
    if _world() > 1 or opt.spatial > 1:
        from robocupvision_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(spatial=opt.spatial, device=device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    with contextlib.ExitStack() as quiet:
        if mesh is not None:
            if mesh.is_main:
                print(f"mesh: data={mesh.shape['data']} "
                      f"spatial={mesh.shape['spatial']}")
            else:  # the other ranks print nothing
                quiet.enter_context(contextlib.redirect_stdout(io.StringIO()))
        return _run(opt, s, dev, mesh)


def _run(opt, s: Setup, dev: torch.device, mesh) -> int:
    """main's sweep on ``dev`` (and ``mesh``)."""
    writes = mesh is None or mesh.is_main

    from robocupvision_tpu_torch.data.datasets import SSYUVDataset
    from robocupvision_tpu_torch.data.device_cache import DeviceCache
    from robocupvision_tpu_torch.train import naming

    camera = s.flags.camera
    if camera != "both" and not opt.finetune:
        print("You can only select camera images for the finetune dataset. "
              "Using both cameras by default")
        camera = "both"
    finetune = opt.finetune
    dec = opt.decay if finetune and not opt.transfer else opt.decay / 10
    transfers = [1, 2, 3, 4] if opt.transfer else [0]
    decays = [10 * dec, 5 * dec, 2 * dec, dec] \
        if (finetune and not opt.transfer) else [dec]

    os.makedirs("output", exist_ok=True)
    os.makedirs("checkpoints", exist_ok=True)

    print(f"Loading dataset from {opt.root} at {s.lab_size} ...")
    train_ds = SSYUVDataset(opt.root, s.lab_size, True, finetune, camera)
    val_ds = SSYUVDataset(opt.root, s.lab_size, False, finetune, camera)
    if len(train_ds) == 0 or len(val_ds) == 0:
        print(f"No data found under {opt.root}")
        return -1
    train_cache = DeviceCache.from_numpy(*train_ds.load_all(), device=dev)
    val_cache = DeviceCache.from_numpy(*val_ds.load_all(), device=dev)
    print(f"train={train_cache.n} val={val_cache.n} images cached on device")

    best_loss_final = 0.0
    done_markers: list = []
    for transfer in transfers:
        if len(transfers) > 1:
            print("#" * 54)
            print(f"############# Finetune with transfer: {transfer} #############")
            print("#" * 54)
        for decay in decays:
            if len(decays) > 1:
                print("#" * 54)
                print(f"############ Finetune with decay: {decay:.1E} ############")
                print("#" * 54)
            # a restarted --resume sweep skips the combos (or their main
            # phase) that finished: a fresh rerun would overwrite their
            # best checkpoint with differently shuffled weights
            marker = None
            main_done = False
            if opt.resume:
                path = naming.train_ckpt_name(s.flags, transfer)
                marker = f"{path}.resume-T{transfer}-{decay:g}.npz.done"
                if os.path.exists(marker):
                    with open(marker) as f:
                        txt = f.read().split()
                    best_loss_final = float(txt[1]) if len(txt) > 1 else 0.0
                    done_markers.append(marker)
                    if txt[:1] == ["done"]:
                        print(f"Skipping completed combo transfer={transfer} "
                              f"decay={decay:g} (resume marker)")
                        continue
                    main_done = True
                    print(f"Skipping completed main phase transfer={transfer} "
                          f"decay={decay:g} (resume marker)")
            best = train_combo(s, train_cache, val_cache, transfer, decay, dev,
                               marker=marker, main_done=main_done, mesh=mesh)
            if best is not None:
                best_loss_final = best
            if marker is not None and writes:
                with open(marker, "w") as f:
                    f.write(f"done {float(best_loss_final)!r}")
                if marker not in done_markers:
                    done_markers.append(marker)
    if mesh is not None:
        mesh.barrier()  # every rank has read the markers
    for m in done_markers:  # whole sweep finished; a fresh rerun retrains
        if writes and os.path.exists(m):
            os.remove(m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
