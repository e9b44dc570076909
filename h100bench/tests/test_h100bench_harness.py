"""The harness: cells, traffic mixes and metrics found by name as files of
their own, the process that fails without a card, and the modules it may
not load."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, small_run

H = ROOT / "h100bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "robocupvision_tpu"}


def modules_imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(H.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(H)))
def test_no_jax_imports(path):
    """Whole top-level names compared: robocupvision_tpu_torch is the port,
    robocupvision_tpu the JAX package; the reference, and the families'
    files that hold each family's reference, import neither."""
    tops = set(modules_imported(path))
    assert not tops & FORBIDDEN
    if {"reference", "families"} & set(path.relative_to(H).parts):
        assert "robocupvision_tpu_torch" not in tops


def test_no_family_named_outside_its_file():
    """Only a family's own file (and the tests) knows a family by name:
    the harness finds it by the configuration's ``family``."""
    families = {p.stem for p in (H / "families").glob("*.py")}
    for path in H.rglob("*.py"):
        if {"families", "tests"} & set(path.relative_to(H).parts):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value not in families, path
            if isinstance(node, (ast.Name, ast.Attribute)):
                name = node.id if isinstance(node, ast.Name) else node.attr
                assert not any(name.startswith(f) for f in families), path


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    from h100bench import core

    monkeypatch.setitem(sys.modules, "robocupvision_tpu_torch_probe",
                        sys.modules["h100bench"])
    assert "robocupvision_tpu_torch_probe" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["h100bench"])
    assert core.forbidden_loaded() == ["jax"]


def test_run_fails_without_a_card():
    """No CUDA card here: exit non-zero, print no result."""
    p = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "robo_unet_vga.label_b32", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files:
    the program cannot be imported, so no result (run past the card
    check on the CPU)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from h100bench import run;"
            "run.execute('robo_unet_vga.label_b32', 1, 1.0, False, "
            "device='cpu')")
    env = {**os.environ, "PYTHONPATH": ""}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "robocupvision_tpu_torch" in p.stderr


@pytest.fixture
def tree_copy(tmp_path, monkeypatch):
    """A copy of the benchmark that core reads instead of the repo's."""
    from h100bench import core

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(core, "ROOT", tmp_path)
    monkeypatch.setattr(core, "HERE", tmp_path / "h100bench")
    return tmp_path


def test_new_files_are_found_by_name(tree_copy, cpu_threads):
    """A configuration, a traffic mix, a limit set and a per-layer metric
    added as new files, and one entry each in BENCHMARK.json, run with no
    file of the benchmark edited."""
    from h100bench import core

    h = tree_copy / "h100bench"
    before = {p: p.read_bytes() for p in h.rglob("*") if p.is_file()}
    cfg = json.loads((h / "configs" / "pb_fcn_vga.json").read_text())
    cfg.update(name="pb_fcn_vga_k3", cfg={**cfg["cfg"], "kernel_size": 3})
    (h / "configs" / "pb_fcn_vga_k3.json").write_text(json.dumps(cfg))
    tr = json.loads((h / "traffic" / "label_b32.json").read_text())
    tr.update(log_frames=8, batch=4, warmup_batches=1, sample_batches=1,
              trace_batches=1)
    (h / "traffic" / "label_tiny.json").write_text(json.dumps(tr))
    (h / "limits" / "pb_fcn_vga_k3.label_tiny.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    (h / "metrics" / "frames_seen.label.py").write_text(
        "def read(run):\n    return run.counts.get('frames')\n")
    man = json.loads((tree_copy / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "pb_fcn_vga_k3", "source": "x",
                           "file": "h100bench/configs/pb_fcn_vga_k3.json",
                           "reduced": ["kernel_size"], "why": "x"})
    man["workloads"].append({"name": "pb_fcn_vga_k3.label_tiny",
                             "config": "pb_fcn_vga_k3",
                             "traffic": "label_tiny", "chips": 1, "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] in ("label_fps", "batch_ms_p95"):
            m["workloads"].append("pb_fcn_vga_k3.label_tiny")
    man["per_layer"].append({"name": "frames_seen.label", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving loop", "moves": "label_fps",
                             "workloads": ["pb_fcn_vga_k3.label_tiny"]})
    (tree_copy / "BENCHMARK.json").write_text(json.dumps(man))

    r = small_run("pb_fcn_vga_k3.label_tiny", seconds=0.2)
    assert r.config["cfg"]["kernel_size"] == 3
    core.load_module("runners", r.traffic["runner"]).run(r)
    assert r.correct, r.compared
    got = core.read_metrics(man, "per_layer", r)
    assert got["frames_seen.label"]["value"] == r.counts["frames"] > 0
    assert set(core.read_metrics(man, "end_to_end", r)) == {
        "label_fps", "batch_ms_p95", "setup_s"}
    for p, data in before.items():   # nothing that was there changed
        assert p.read_bytes() == data


PB_FCN_2 = '''"""PB_FCN_2 (model.py:416-459), segmentation mode: the flagship's
plan under the same block names, without the no_scale level, as
build_packed_infer serves it; its classification head is off the path."""

from h100bench import core


def _flagship(cfg):
    return {**cfg, "no_scale": False, "pool": False, "v2": False,
            "class_size": 1}


def _robo_unet():
    return core.load_module("families", "robo_unet")


def forward(p, cfg, x, train=False):
    return _robo_unet().forward(p, _flagship(cfg), x, train)


def flops(cfg, h, w):
    return _robo_unet().flops(_flagship(cfg), h, w)


def k2_chains(config, n, h, w):
    return _robo_unet().k2_chains({**config, "cfg": _flagship(config["cfg"])},
                                  n, h, w)
'''


def test_new_family_is_new_files(tree_copy, cpu_threads):
    """A zoo family the benchmark does not run (PB_FCN_2), its builder
    named as a ``module:function`` path, added as new files only (its
    family file, its configuration, a traffic mix, its limits) and the
    cell's entries in BENCHMARK.json: the cell runs to ``correct``, and
    its FLOPs are the family file's."""
    from h100bench import core, counts

    h = tree_copy / "h100bench"
    before = {p: p.read_bytes() for p in h.rglob("*") if p.is_file()}
    (h / "families" / "pb_fcn_2.py").write_text(PB_FCN_2)
    cfg = json.loads((h / "configs" / "robo_unet_vga.json").read_text())
    cfg.update(name="pb_fcn_2_vga", family="pb_fcn_2",
               cfg_class="PBFCN2Cfg",
               cfg={"classify": False, "num_classes": 5, "planes": 8,
                    "depth": 4, "levels": 2, "belly_size": 5,
                    "belly_planes": 128})
    cfg["serve"]["build"] = \
        "robocupvision_tpu_torch.models.packed:build_packed_infer"
    (h / "configs" / "pb_fcn_2_vga.json").write_text(json.dumps(cfg))
    tr = json.loads((h / "traffic" / "label_b32.json").read_text())
    tr.update(log_frames=8, batch=4, warmup_batches=1, sample_batches=2,
              trace_batches=1)
    (h / "traffic" / "label_tiny.json").write_text(json.dumps(tr))
    (h / "limits" / "pb_fcn_2_vga.label_tiny.json").write_text(
        json.dumps({"logit_gap": 0.6}))
    man = json.loads((tree_copy / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "pb_fcn_2_vga", "source": "x",
                           "file": "h100bench/configs/pb_fcn_2_vga.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "pb_fcn_2_vga.label_tiny",
                             "config": "pb_fcn_2_vga",
                             "traffic": "label_tiny", "chips": 1, "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] in ("label_fps", "batch_ms_p95"):
            m["workloads"].append("pb_fcn_2_vga.label_tiny")
    (tree_copy / "BENCHMARK.json").write_text(json.dumps(man))

    r = small_run("pb_fcn_2_vga.label_tiny", seconds=0.2)
    core.load_module("runners", r.traffic["runner"]).run(r)
    assert r.correct, r.compared
    assert r.attempted > 0 and r.failed == 0
    assert set(core.read_metrics(man, "end_to_end", r)) == {
        "label_fps", "batch_ms_p95", "setup_s"}
    flagship = {**core.config("robo_unet_vga")["cfg"], "no_scale": False}
    assert counts.model_flops(r.config, 64, 96) == core.load_module(
        "families", "robo_unet").flops(flagship, 64, 96)
    assert core.load_module("metrics", "mfu.label").read(r) > 0
    assert [c.tag for c in counts.k2_chains(r.config, 4, 64, 96)] == [
        "down", "deep", "up"]
    for p, data in before.items():   # nothing that was there changed
        assert p.read_bytes() == data


def test_weight_kinds_of_a_family(tree_copy):
    """A kind weights.py lacks is drawn as the family file's WEIGHT_KINDS
    says (a normal scale, or a uniform span and offset); the kinds it
    knows are drawn as before, the family file unread."""
    import torch

    from h100bench import weights

    (tree_copy / "h100bench" / "families" / "kinds_probe.py").write_text(
        "WEIGHT_KINDS = {'ln_w': (0.4, 0.8), 'attn_w': 0.02}\n")
    specs = [("a.weight", (3, 3, 4, 8), (8, 4, 3, 3), "conv_w"),
             ("n.weight", (4096,), (4096,), "ln_w"),
             ("q.weight", (64, 64), (64, 64), "attn_w"),
             ("n.bias", (8,), (8,), "bn_b")]
    w = weights.make(specs, 5, torch.device("cpu"), "kinds_probe")
    assert 0.8 <= w["n.weight"].min() and w["n.weight"].max() < 1.2
    assert abs(w["q.weight"].std().item() - 0.02) < 0.002
    assert abs(w["q.weight"].mean().item()) < 0.002
    known = [specs[0], specs[3]]
    a = weights.make(known, 5, torch.device("cpu"), "kinds_probe")
    b = weights.make(known, 5, torch.device("cpu"), "no_such_family")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_unknown_weight_kind_names_the_file(tree_copy):
    import torch

    from h100bench import weights

    (tree_copy / "h100bench" / "families" / "kinds_none.py").write_text(
        "def forward(p, cfg, x, train=False):\n    return x\n")
    specs = [("g", (4,), (4,), "gamma")]
    with pytest.raises(ValueError, match=r"'gamma'.*h100bench/families/"
                                         r"kinds_none\.py"):
        weights.make(specs, 5, torch.device("cpu"), "kinds_none")


def test_builder_is_the_programs():
    """A bare name is a function of models.packed; a ``module:function``
    path has to name a module of the port, whole names compared."""
    from robocupvision_tpu_torch.models import packed

    from h100bench import program

    assert program.builder("build_packed_pb_fcn") \
        is packed.build_packed_pb_fcn
    assert program.builder(
        "robocupvision_tpu_torch.models.packed:build_packed_infer") \
        is packed.build_packed_infer
    for name in ("os:system", "h100bench.reference.nets:conv",
                 "robocupvision_tpu_torch_probe.packed:build"):
        with pytest.raises(ValueError, match="outside robocupvision_tpu_torch"):
            program.builder(name)


def test_k2_roofline_without_k2_chains(tree_copy):
    """A family file without k2_chains: K2's roofline reads None, not an
    error, where a family with chains reads a share."""
    import types

    from h100bench import core, trace

    (tree_copy / "h100bench" / "families" / "no_chains.py").write_text(
        "def flops(cfg, h, w):\n    return 1\n")
    t = trace.Trace(window=(0.0, 1.0), device=[("chain_kernel_f", 0.0, 0.5)],
                    spans=[])
    cfg = core.config("pb_fcn_vga")
    run = types.SimpleNamespace(traced=t, counts={"traced_frames": 64},
                                config=cfg, traffic={"batch": 32})
    reader = core.load_module("metrics", "k2_roofline.label")
    assert reader.read(run) > 0
    run.config = {**cfg, "family": "no_chains"}
    assert reader.read(run) is None


def shrink(tree, cell):
    """The cell's files in the copy cut to a size a test can hold."""
    from h100bench import core

    h = tree / "h100bench"
    w = core.workload(core.manifest(), cell)
    cfg_p = h / "configs" / f"{w['config']}.json"
    cfg = json.loads(cfg_p.read_text())
    cfg["frame"] = [64, 96]
    cfg_p.write_text(json.dumps(cfg))
    tr_p = h / "traffic" / f"{w['traffic']}.json"
    tr = json.loads(tr_p.read_text())
    tr.update(log_frames=8, batch=4, warmup_batches=1, sample_batches=1,
              trace_batches=1)
    tr_p.write_text(json.dumps(tr))


def test_result_line(tree_copy, cpu_threads):
    """The result's keys, ``compared`` last, each number beside its
    limit; the metrics of the cell's section, each with its unit."""
    from h100bench import run

    shrink(tree_copy, "pb_fcn_vga.label_b32")
    r, result = run.execute("pb_fcn_vga.label_b32", 3, 0.2, False,
                            device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "compared"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == r.counts["frames"] > 0
    assert set(result["metrics"]) == {"label_fps", "batch_ms_p95",
                                      "setup_s"}
    assert result["metrics"]["label_fps"]["unit"] == "frames/s"
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["compared"]["logit_gap"]) == {"value", "limit"}
    json.dumps(result)


def test_trace_reductions():
    """Busy time as a union, kernels apart from copies, idle gaps laid to
    the innermost span open at their middle."""
    from h100bench import trace

    t = trace.Trace(
        window=(0.0, 10.0),
        device=[("k_a", 1.0, 3.0), ("k_b", 2.0, 4.0),
                ("Memcpy HtoD (Pageable -> Device)", 6.0, 7.0),
                ("k_a", 9.5, 11.0)],
        spans=[("train_epoch", 0.0, 8.0), ("train_step", 4.0, 6.0),
               ("valid_epoch", 8.0, 10.0)])
    assert t.busy_s() == 3.0 + 1.0 + 0.5
    assert t.busy_s(2.5, 6.5) == 1.5 + 0.5
    assert [n for n, _, _ in t.kernels()] == ["k_a", "k_b", "k_a"]
    gaps = dict(t.idle_gaps())
    # 0-1 in train_epoch, 4-6 in train_step; 7-9.5 whole to valid_epoch,
    # open at its middle
    assert gaps == {"train_epoch": 1.0, "train_step": 2.0,
                    "valid_epoch": 2.5}
    assert t.top_ops(1) == [["k_a", 3.5]]
    assert trace.union_length([(0, 1), (0.5, 2), (3, 4)]) == 3.0
