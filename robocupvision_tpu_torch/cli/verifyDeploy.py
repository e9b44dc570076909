"""Deployment verification CLI (the JAX package's cli/verifyDeploy.py).

Checks a deployment directory (net.cfg + weights.dat) three ways:
1. the cfg interpreter (``netcfg.run_cfg``) against the native C++ engine,
   final output;
2. their argmax label maps;
3. with ``--checkpoint``, the interpreter against the live model of that
   checkpoint (softmaxed, ``deploy.verify_deployment``).

    python -m robocupvision_tpu_torch.cli.verifyDeploy --dir weights/ \
        --family pb_fcn --checkpoint pth/bestModelSeg.pth

The interpreter and the live model run on the CUDA card;
``main(argv, device="cpu")`` runs them on the CPU. The engine is the
robot's and runs on the host CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device


def main(argv=None, device: DeviceLike = None) -> int:
    p = argparse.ArgumentParser(description="Verify a cfg+weights deployment")
    p.add_argument("--dir", required=True, help="deployment directory")
    p.add_argument("--family", default="pb_fcn",
                   choices=["pb_fcn", "label_prop", "robo_unet"])
    p.add_argument("--checkpoint", default="",
                   help="optional checkpoint to re-export and compare against")
    p.add_argument("--planes", type=int, default=32)
    p.add_argument("--numClasses", type=int, default=5)
    p.add_argument("--kernelSize", type=int, default=1)
    p.add_argument("--noScale", action="store_true", default=False)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--width", type=int, default=64)
    opt = p.parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.export import deploy, netcfg
    from robocupvision_tpu_torch.export.engine import NativeEngine
    from robocupvision_tpu_torch.models import zoo
    from robocupvision_tpu_torch.train import checkpoint

    kwargs = dict(planes=opt.planes, num_classes=opt.numClasses)
    if opt.family == "pb_fcn":
        kwargs.update(no_scale=opt.noScale, kernel_size=opt.kernelSize)
    model = zoo.make(opt.family, device=dev, **kwargs)

    cfg_path = os.path.join(opt.dir, "net.cfg")
    dat = [f for f in os.listdir(opt.dir)
           if f.endswith(".dat")] if os.path.isdir(opt.dir) else []
    if not os.path.exists(cfg_path) or not dat:
        print(f"missing net.cfg / *.dat under {opt.dir}")
        return -1
    dat_path = os.path.join(opt.dir, sorted(dat)[0])

    in_ch = 8 if opt.family == "label_prop" else 3
    x = np.random.default_rng(0).standard_normal(
        (1, opt.height, opt.width, in_ch)).astype(np.float32)

    secs = netcfg.parse_cfg(cfg_path)
    flat = np.fromfile(dat_path, dtype="<f4")
    try:
        with torch.no_grad():
            cfg_out = netcfg.run_cfg(secs, flat, torch.from_numpy(x).to(dev)
                                     ).cpu().numpy()
        eng = NativeEngine(cfg_path, dat_path)
    except (ValueError, RuntimeError) as e:
        print(f"FAIL: artifacts do not describe a consistent network ({e})")
        return 1
    if not eng.weights_fully_consumed:
        print("FAIL: weights.dat length does not match the cfg graph")
        return 1
    eng_out = eng.forward(np.ascontiguousarray(x[0].transpose(2, 0, 1)))
    diff = float(np.abs(eng_out - cfg_out[0].transpose(2, 0, 1)).max())
    agree = float((eng_out.argmax(0) == cfg_out[0].argmax(-1)).mean())
    print(f"engine vs cfg interpreter: max|diff|={diff:.2e}, "
          f"label agreement={agree:.6f}")
    # the engine builds with FMA contraction; ~1e-3 absolute drift on the
    # softmax outputs is expected, label agreement is the operative check
    ok = diff < 5e-3 and agree > 0.999

    if opt.checkpoint:
        try:
            state = checkpoint.load_any(opt.checkpoint, model.registry)
            d = deploy.verify_deployment(opt.dir, model, state, x,
                                         fname=os.path.basename(dat_path))
            print(f"artifacts vs live model: max|diff|={d:.2e}")
        except (AssertionError, KeyError, ValueError, FileNotFoundError,
                RuntimeError) as e:
            print(f"FAIL: checkpoint comparison ({e})")
            ok = False

    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
