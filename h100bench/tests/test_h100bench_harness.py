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
    robocupvision_tpu the JAX package; the reference imports neither."""
    tops = set(modules_imported(path))
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(H).parts:
        assert "robocupvision_tpu_torch" not in tops


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
