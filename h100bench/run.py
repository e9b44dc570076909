"""Run one cell of the benchmark of robocupvision_tpu_torch on the CUDA card
this process finds.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Looks the cell up in BENCHMARK.json, loads its configuration, traffic mix
and limits from the files of their names under h100bench/, and hands a
``core.Run`` to the traffic mix's runner, which builds, warms up, measures for
``--seconds`` and checks its outputs against the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each from its reader under end_to_end/
or metrics/), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the check compared beside its limit, as the
last lines of standard error also give them. Everything else the run
prints goes to standard error.

Exits non-zero without a result when no CUDA card is present or fewer
than the cell asks for, when the program cannot be imported, and when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".h100bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))


class NoCard(RuntimeError):
    pass


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device=None, t_start: float = T_START):
    """Run the cell; returns (core.Run, result dict). ``device``: the
    card (cuda:0) unless given."""
    import torch

    from h100bench import core

    man = core.manifest()
    cell = core.workload(man, workload)
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device is available")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"the cell asks for {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    import robocupvision_tpu_torch  # noqa: F401  the system under test

    traffic = core.traffic(cell["traffic"])
    r = core.Run(cell=cell, config=core.config(cell["config"]),
                 traffic=traffic, limits=core.limits(workload), seed=seed,
                 seconds=seconds, trace=trace, device=torch.device(device),
                 t_start=t_start)
    core.load_module("runners", traffic["runner"]).run(r)
    found = core.forbidden_loaded()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{found}")
    section = "per_layer" if trace else "end_to_end"
    dev = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
           "kind": (torch.cuda.get_device_name(r.device)
                    if r.device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": r.memory_peak_bytes}
    result = {"correct": r.correct, "attempted": r.attempted,
              "failed": r.failed,
              "metrics": core.read_metrics(man, section, r), "device": dev}
    if trace and r.traced is not None:
        dev["busy_s"] = r.traced.busy_s()
        dev["window_s"] = r.traced.window_s
        result["breakdown"] = {"device_ops": r.traced.top_ops(),
                               "idle_gaps": r.traced.idle_gaps()}
    if r.device.type == "cuda":
        dev["card"] = power_limit()
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in r.compared.items()}
    return r, result


def main(argv=None) -> int:
    args = parse(argv)
    out = sys.stdout
    try:
        with contextlib.redirect_stdout(sys.stderr):
            r, result = execute(args.workload, args.seed, args.seconds,
                                bool(args.trace))
    except NoCard as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 2
    print("set-up phases (s since start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in r.phases.items()), file=sys.stderr)
    if r.traced is not None:
        print(f"trace: the markers' clocks agree within "
              f"{r.traced.align_error_s * 1e6:.1f} us", file=sys.stderr)
    for k, c in result["compared"].items():
        ok = "within" if c["value"] <= c["limit"] else "OVER"
        print(f"compared {k}: {c['value']!r} {ok} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
