"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
nothing of it (nor chip_smoke.py) imports Pillow when a module is imported
(the card's machine has none), and its entry points never fall back to the
CPU on their own."""

import ast
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "robocupvision_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "robocupvision_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def _module_level_imports(path):
    """Names imported by statements that run when ``path`` is imported
    (function bodies excluded)."""
    todo = [ast.parse(path.read_text(), filename=str(path))]
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_pil_at_module_level(path):
    for name in _module_level_imports(path):
        assert name.split(".")[0] != "PIL", f"{path.name} imports {name}"


def _entry_points():
    from robocupvision_tpu_torch.cli import (classTrainer, classVal,
                                             labelPropTrain, objDetEval,
                                             test, tester, train, trainer,
                                             validLabelProp)
    from robocupvision_tpu_torch.data.device_cache import DeviceCache
    from robocupvision_tpu_torch.data.streaming import StreamingBatches
    from robocupvision_tpu_torch.models import packed, zoo
    from robocupvision_tpu_torch.ops import metrics
    from robocupvision_tpu_torch.utils.serving import ServingPipeline

    cpu_model = zoo.make("robo_unet", device="cpu")
    cpu_pb_fcn = zoo.make("pb_fcn", device="cpu")
    cpu_lp = zoo.make("label_prop", device="cpu")
    maps = np.zeros((1, 4, 4), np.int32)
    return {
        "zoo.make": lambda: zoo.make("robo_unet"),
        "build_packed_infer": lambda: packed.build_packed_infer(cpu_model),
        "build_packed_pb_fcn": lambda: packed.build_packed_pb_fcn(cpu_pb_fcn),
        "build_packed_label_prop": lambda: packed.build_packed_label_prop(
            cpu_lp),
        "seg_batch_stats": lambda: metrics.seg_batch_stats(maps, maps, 5),
        "ServingPipeline": lambda: ServingPipeline(lambda x: x),
        "tester.main": lambda: tester.main(["--noScale"]),
        "tester.serve_and_score": lambda: tester.serve_and_score(
            lambda x: x, [], 5),
        "validLabelProp.main": lambda: validLabelProp.main([]),
        "validLabelProp.serve_and_score":
            lambda: validLabelProp.serve_and_score(lambda x: x, []),
        "test.main": lambda: test.main(["--UNet"]),
        "classTrainer.main": lambda: classTrainer.main([]),
        "trainer.main": lambda: trainer.main([]),
        "labelPropTrain.main": lambda: labelPropTrain.main([]),
        "classTrainer.train_classifier": lambda: classTrainer.train_classifier(
            classTrainer.build_parser().parse_args([]), None, None),
        "DeviceCache": lambda: DeviceCache.from_numpy(
            np.zeros((1, 4, 4, 3), np.float32), maps),
        "train.main": lambda: train.main([]),
        "classVal.main": lambda: classVal.main([]),
        "objDetEval.main": lambda: objDetEval.main([]),
        "StreamingBatches": lambda: StreamingBatches([], 4),
        "zoo.make(bnn)": lambda: zoo.make("bnn"),
    }


@pytest.mark.parametrize("name", ["zoo.make", "build_packed_infer",
                                  "build_packed_pb_fcn", "seg_batch_stats",
                                  "ServingPipeline", "tester.main",
                                  "tester.serve_and_score",
                                  "build_packed_label_prop",
                                  "validLabelProp.main",
                                  "validLabelProp.serve_and_score",
                                  "test.main", "DeviceCache",
                                  "classTrainer.main", "trainer.main",
                                  "labelPropTrain.main",
                                  "classTrainer.train_classifier",
                                  "train.main", "classVal.main",
                                  "objDetEval.main", "StreamingBatches",
                                  "zoo.make(bnn)"])
def test_entry_points_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
