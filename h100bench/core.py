"""What every cell shares: the manifest and the files found by name, the
record of one run, the result line and the checks around it.

Everything that belongs to one configuration, one traffic mix, one limit
set or one metric sits in a file of its own under this directory, found by
the name ``BENCHMARK.json`` gives it:

    configs/<config>.json        sizes, dtypes, peaks of a configuration,
                                 its ``family`` and the port's function
                                 that builds its served graph
    families/<family>.py         a model family: forward(p, cfg, x,
                                 train=False), the plain f32 reference;
                                 flops(cfg, h, w); optionally
                                 k2_chains(config, n, h, w) and
                                 WEIGHT_KINDS (weights.py)
    traffic/<traffic>.json       the parameters of a traffic mix, and the
                                 runner (runners/<runner>.py) that runs it
    limits/<workload>.json       the limit of each number ``correct`` compares
    end_to_end/<metric>.py       read(run) -> value or None
    metrics/<metric>.py          read(run) -> value or None (per-layer)

A later cell, traffic mix, metric or model family is added as new files
of these kinds, and the cell's entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "robocupvision_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(HERE / "limits" / f"{workload_name}.json")


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"h100bench_{kind}_" + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, section: str, cell: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those whose ``workloads`` list it, or that have none."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each of a run's random streams
    (weights, data, draws), from the run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63 - 1)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float


@dataclasses.dataclass
class Run:
    """One run of one cell: what the runner is given and what it records."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any                 # torch.device
    t_start: float              # perf_counter() when the process started
    setup_s: Optional[float] = None
    window: Optional[Tuple[float, float]] = None   # perf_counter() times
    attempted: int = 0
    failed: int = 0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    spans: List[Span] = dataclasses.field(default_factory=list)
    traced: Any = None          # trace.Trace of the traced segment
    compared: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)   # name -> (value, limit)
    memory_peak_bytes: int = 0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (seconds since the process
        started), for the set-up's account on standard error."""
        import time

        self.phases[name] = time.perf_counter() - self.t_start

    def compare(self, name: str, value: float) -> None:
        """Record a number the check compares, beside its limit."""
        self.compared[name] = (float(value), float(self.limits[name]))

    @property
    def correct(self) -> bool:
        if self.failed or not self.compared:
            return False
        return all(math.isfinite(v) and v <= lim
                   for v, lim in self.compared.values())

    @property
    def window_s(self) -> Optional[float]:
        return None if self.window is None else self.window[1] - self.window[0]

    def window_span_total(self, name: str) -> float:
        """Seconds inside spans ``name`` that lie in the window."""
        a, b = self.window
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.name == name and s.t0 >= a and s.t1 <= b)


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds (whole
    names compared: ``robocupvision_tpu_torch`` is not
    ``robocupvision_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def read_metrics(man: dict, section: str, run: Run) -> Dict[str, dict]:
    """Each metric of ``section`` this cell reports, by its reader; a
    reader that finds nothing returns None and the metric is left out."""
    kind = "end_to_end" if section == "end_to_end" else "metrics"
    out = {}
    for m in metrics_of(man, section, run.cell["name"]):
        value = load_module(kind, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
