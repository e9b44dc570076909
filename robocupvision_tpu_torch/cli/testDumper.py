"""Golden-vector dump CLI, the reference's ``python testDumper.py`` (the
JAX package's cli/testDumper.py).

For every layer type the deployment format supports, writes into
``tests_golden/``:
  - the random inputs (dataC1.npy, dataF.npy: raw float32, CHW, like the
    reference's ``.tofile`` dumps);
  - each case's weights (<Name>.npy) in the flat weights.dat order;
  - each case's output (out<Name>.npy, CHW), from ``netcfg.run_cfg``;
plus a cfg per case (<Name>.cfg), so that an external engine can replay
them without this repository's Python (tests replay them on the in-repo
C++ engine, export/engine.py).

    python -m robocupvision_tpu_torch.cli.testDumper --out tests_golden

computes the outputs on the CUDA card; ``main(argv, device="cpu")`` on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device


CASES = [
    ("FC", [("connected", dict(outputs=16, inputs=32))], (1, 1, 32)),
    ("BN", [("batchnorm", dict(activation="linear"))], (32, 32, 4)),
    ("Short", [("convolutional", dict(filters=4, size=1, stride=1, pad=0,
                                      dilation=1, hasBias=0)),
               ("shortcut", {"from": 0, "activation": "linear"})], (32, 32, 4)),
    ("Cat", [("convolutional", dict(filters=4, size=1, stride=1, pad=0,
                                    dilation=1, hasBias=0)),
             ("concat", {"from": 0})], (32, 32, 4)),
    ("Reorg", [("pixelshuffle", dict(factor=2))], (32, 32, 4)),
    ("SM", [("softmax", {})], (32, 32, 4)),
    ("MP", [("maxpool", dict(size=2, stride=2))], (32, 32, 4)),
    ("AP", [("avgpool", dict(size=2, stride=2))], (32, 32, 4)),
    ("C1", [("convolutional", dict(filters=8, size=3, stride=1, pad=1,
                                   dilation=1, hasBias=1))], (32, 32, 4)),
    ("C2", [("convolutional", dict(filters=8, size=3, stride=2, pad=1,
                                   dilation=1, hasBias=1))], (32, 32, 4)),
    ("C3", [("convolutional", dict(filters=8, size=3, stride=1, pad=2,
                                   dilation=2, hasBias=1))], (32, 32, 4)),
    ("C4", [("convolutional", dict(filters=8, size=3, stride=2, pad=2,
                                   dilation=2, hasBias=1))], (32, 32, 4)),
    ("C5", [("convolutional", dict(filters=8, size="3x1", stride=1, pad="1x0",
                                   dilation=1, hasBias=1))], (32, 32, 4)),
    ("C6", [("convolutional", dict(filters=8, size="3x1", stride=2, pad="1x0",
                                   dilation=1, hasBias=1))], (32, 32, 4)),
    ("C7", [("convolutional", dict(filters=8, size="3x1", stride=1, pad="2x0",
                                   dilation="2x1", hasBias=1))], (32, 32, 4)),
    ("C8", [("convolutional", dict(filters=8, size="3x1", stride=2, pad="2x0",
                                   dilation="2x1", hasBias=1))], (32, 32, 4)),
    ("C9", [("convolutional", dict(filters=8, size="1x3", stride=1, pad="0x1",
                                   dilation=1, hasBias=1))], (32, 32, 4)),
    ("C10", [("convolutional", dict(filters=8, size="1x3", stride=2, pad="0x1",
                                    dilation=1, hasBias=1))], (32, 32, 4)),
    ("C11", [("convolutional", dict(filters=8, size="1x3", stride=1, pad="0x2",
                                    dilation="1x2", hasBias=1))], (32, 32, 4)),
    ("C12", [("convolutional", dict(filters=8, size="1x3", stride=2, pad="0x2",
                                    dilation="1x2", hasBias=1))], (32, 32, 4)),
    ("C13", [("convolutional", dict(filters=8, size=1, stride=1, pad=0,
                                    dilation=1, hasBias=1))], (32, 32, 4)),
    ("TrC", [("transposedconv", dict(filters=8, size=3, stride=2, pad=1,
                                     outpad=1))], (32, 32, 4)),
]


def _weights_for(sections, cin, rng):
    flat = []
    c = cin
    for name, kv in sections[1:]:
        if name == "convolutional":
            size = str(kv.get("size", 1))
            kh, kw = (int(s) for s in size.split("x")) if "x" in size \
                else (int(size), int(size))
            flat.append(rng.standard_normal(kv["filters"] * c * kh * kw))
            if int(kv.get("hasBias", 1)):
                flat.append(rng.standard_normal(kv["filters"]))
            c = kv["filters"]
        elif name == "transposedconv":
            k = int(kv.get("size", 3))
            flat.append(rng.standard_normal(c * kv["filters"] * k * k))
            flat.append(rng.standard_normal(kv["filters"]))
            c = kv["filters"]
        elif name == "batchnorm":
            flat.append(rng.standard_normal(c))
            flat.append(rng.standard_normal(c))
            flat.append(rng.standard_normal(c))
            flat.append(np.abs(rng.standard_normal(c)) + 0.5)
        elif name == "connected":
            flat.append(rng.standard_normal(kv["outputs"] * kv["inputs"]))
            flat.append(rng.standard_normal(kv["outputs"]))
            c = kv["outputs"]
        elif name == "concat":
            c = c * 2 if kv["from"] == 0 else c
    if not flat:
        return np.zeros(0, np.float32)
    return np.concatenate([np.asarray(f).reshape(-1)
                           for f in flat]).astype(np.float32)


def main(argv=None, device: DeviceLike = None) -> int:
    p = argparse.ArgumentParser(description="Golden vector dumper")
    p.add_argument("--out", type=str, default="tests_golden")
    opt = p.parse_args(argv)
    dev = resolve_device(device)

    from robocupvision_tpu_torch.export import netcfg

    os.makedirs(opt.out, exist_ok=True)
    rng = np.random.default_rng(12345678)

    data_c1 = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    data_f = rng.standard_normal((1, 1, 1, 32)).astype(np.float32)
    np.transpose(data_c1[0], (2, 0, 1)).reshape(-1).tofile(
        os.path.join(opt.out, "dataC1.npy"))
    data_f.reshape(-1).tofile(os.path.join(opt.out, "dataF.npy"))

    for name, layer_secs, (h, w, cin) in CASES:
        sections = [("net", dict(height=h, width=w, channels=cin, downscale=1))]
        sections += layer_secs
        flat = _weights_for(sections, cin, np.random.default_rng(
            zlib.crc32(name.encode())))  # stable across processes (str hash is salted)
        x = torch.from_numpy(data_f if name == "FC" else data_c1).to(dev)

        netcfg.write_cfg(os.path.join(opt.out, name + ".cfg"), sections)
        flat.tofile(os.path.join(opt.out, name + ".npy"))
        with torch.no_grad():
            out = netcfg.run_cfg(sections, flat, x).cpu().numpy()
        np.transpose(out[0], (2, 0, 1)).reshape(-1).tofile(
            os.path.join(opt.out, "out" + name + ".npy"))
        print(name)
    print(f"wrote golden vectors for {len(CASES)} layer configs to {opt.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
