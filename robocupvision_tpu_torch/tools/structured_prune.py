"""Structured-pruning CLI (the JAX package's tools/structured_prune.py, over
ops/slim.py).

Two modes over a checkpoint of a deployable family:

- ``--keep N``: belly-only pruning (``slim.shrink_belly``) removes
  ROBO-UNet bottleneck channels; the result is a standard ROBO-UNet with
  belly_planes=N.
- ``--ratio R``: whole-network structured pruning scores every channel
  group (skip-coupled sets prune together), zeroes the lowest R share of
  each and compacts to a slim checkpoint with its own per-layer widths,
  saved with the slim marker (every consumer is width-driven). For the
  masked finetune between prune and compact, use ``cli.train
  --pruneStruct``.

    python -m robocupvision_tpu_torch.tools.structured_prune \\
        --checkpoint checkpoints/bestFinetune.weights --ratio 0.5 \\
        --out checkpoints/bestFinetuneSlim.weights --deploy weightsSlim/

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

from robocupvision_tpu_torch.device import DeviceLike, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Structured pruning")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--keep", type=int, help="belly channels to keep "
                      "(belly-only mode)")
    mode.add_argument("--ratio", type=float, help="fraction of each channel "
                      "group to prune (whole-network mode)")
    p.add_argument("--roundTo", type=int, default=8, help="round kept widths "
                   "up to a multiple (whole-network mode)")
    p.add_argument("--minKeep", type=int, default=8,
                   help="minimum kept channels per group")
    p.add_argument("--deploy", default="", help="optional deployment dir")
    p.add_argument("--family", default="robo_unet",
                   choices=["robo_unet", "pb_fcn", "label_prop"],
                   help="checkpoint's model family (whole-network mode "
                        "takes every deployable family; belly mode is "
                        "robo_unet only)")
    # architecture flags (train.py / trainer.py / labelPropTrain defaults)
    p.add_argument("--noScale", action="store_true", default=False)
    p.add_argument("--v2", action="store_true", default=False)
    p.add_argument("--UNet", action="store_true", default=False)
    p.add_argument("--numClasses", type=int, default=5)
    p.add_argument("--planes", type=int, default=0,
                   help="override planes (pb_fcn/label_prop default 32)")
    return p


def main(argv=None, device: DeviceLike = None) -> int:
    p = build_parser()
    opt = p.parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.cli.train import model_hyper
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.ops import slim
    from robocupvision_tpu_torch.train import checkpoint

    if opt.family == "robo_unet":
        hyper = model_hyper(opt.UNet, opt.v2)
        if opt.planes:
            hyper["planes"] = opt.planes
        model = zoo.make("robo_unet", no_scale=opt.noScale, pool=opt.UNet,
                         num_classes=opt.numClasses, v2=opt.v2, device=dev,
                         **hyper)
        before = sum(zoo.robo_unet_get_computations(model.cfg))
    elif opt.family == "pb_fcn":
        model = zoo.make("pb_fcn", planes=opt.planes or 32,
                         num_classes=opt.numClasses, no_scale=opt.noScale,
                         device=dev)
        before = 0
    else:
        model = zoo.make("label_prop", planes=opt.planes or 32,
                         num_classes=opt.numClasses, device=dev)
        before = 0
    if opt.keep is not None and opt.family != "robo_unet":
        p.error("--keep (belly mode) is robo_unet only; use --ratio")
    params = checkpoint.load_any(opt.checkpoint, model.registry)

    if opt.keep is not None:
        new_params, new_cfg, _ = slim.shrink_belly(params, model.cfg,
                                                   opt.keep)
        new_model = zoo.Model("robo_unet", new_cfg, new_params).to(dev)
        after = sum(zoo.robo_unet_get_computations(new_cfg))
        print(f"belly {model.cfg.belly_planes} -> {opt.keep} channels; "
              f"{before / 1e6:.0f} -> {after / 1e6:.0f} MFLOPs "
              f"({100 * (1 - after / before):.1f}% fewer)")
        checkpoint.save(opt.out, new_model.registry, new_params)
    else:
        masked, _ = slim.prune_channels(params, slim.channel_groups(model),
                                        opt.ratio, min_keep=opt.minKeep,
                                        round_to=opt.roundTo)
        new_params, _ = slim.compact(model, masked)
        new_model = model
        n0, n1 = slim.param_count(params), slim.param_count(new_params)
        msg = f"slim: {n0} -> {n1} params ({100 * (1 - n1 / n0):.1f}% fewer)"
        if before:  # the analytic op model is robo_unet's only
            # widths from the compacted shapes: the slim net's own cost
            after = sum(zoo.robo_unet_get_computations(model.cfg, new_params,
                                                       pruned=True))
            msg += (f"; {before / 1e6:.0f} -> {after / 1e6:.0f} MFLOPs "
                    f"({100 * (1 - after / before):.1f}% fewer)")
        print(msg)
        checkpoint.save(opt.out, model.registry, new_params, slim=True)
    print(f"saved {opt.out}")
    if opt.deploy:
        from robocupvision_tpu_torch.export import deploy

        deploy.export_deployment(opt.deploy, new_model, new_params)
        print(f"exported {opt.deploy}/net.cfg + weights.dat")
    return 0


if __name__ == "__main__":
    sys.exit(main())
