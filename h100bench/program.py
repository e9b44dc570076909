"""The system under test as the benchmark builds it: the port's model with
the benchmark's seeded weights, its served graph, and its optimizers. Only
what a user of the port calls: the zoo, the functions that build a served
graph, the Trainer and its step configuration."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

import torch

from h100bench import weights as bench_weights

PROGRAM = "robocupvision_tpu_torch"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model(config: dict, seed: int, device) -> Tuple[object, Dict]:
    """(the port's Model, a copy of its weights for the reference), the
    weights drawn on ``device`` from ``seed``."""
    from robocupvision_tpu_torch.models import zoo

    fam = config["family"]
    cfg = getattr(zoo, config["cfg_class"])(**config["cfg"])
    reg = getattr(zoo, fam + "_registry")(cfg)
    w = bench_weights.make(bench_weights.specs_of(reg), seed, device, fam)
    ref = {k: v.clone() for k, v in w.items()}
    return zoo.Model(fam, cfg, w), ref


def builder(name: str) -> Callable:
    """The port's function that builds a served graph, by the name a
    configuration's ``serve.build`` gives: a bare name in
    ``robocupvision_tpu_torch.models.packed``, or ``module:function`` with
    the module in ``robocupvision_tpu_torch``."""
    module, sep, fn = name.rpartition(":")
    if not sep:
        module = PROGRAM + ".models.packed"
    elif module != PROGRAM and not module.startswith(PROGRAM + "."):
        raise ValueError(
            f"serve.build {name!r} names a module outside {PROGRAM}: the "
            f"served graph is the program's own, and the benchmark builds "
            f"nothing else")
    return getattr(importlib.import_module(module), fn)


def served_graph(config: dict, model, variant: str = "program",
                 calib_u8=None):
    """The configuration's served graph (``serve``: build, by
    ``builder``; dtype; options). ``variant="control"``: the program's own
    path one precision below the stated one (``serve.control``): ``int8``,
    the graph quantized by ``quantize_int8`` on ``calib_u8``; or a dtype,
    the graph built in it."""
    from robocupvision_tpu_torch.models import packed
    from robocupvision_tpu_torch.ops.color import raw_camera_preprocess

    sv = config["serve"]
    build = builder(sv["build"])
    dtype = sv["dtype"]
    control = sv["control"] if variant == "control" else None
    if control is not None and control != "int8":
        dtype = control
    pi = build(model, None, DTYPES[dtype], device=model.device,
               **sv["options"])
    if control == "int8":
        with torch.no_grad():
            calib = raw_camera_preprocess(
                torch.as_tensor(calib_u8).to(model.device))
        pi = packed.quantize_int8(pi, calib)
    return pi
