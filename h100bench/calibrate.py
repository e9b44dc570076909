"""Readings that the limits of ``correct`` are set from, at a cell's own
sizes, on the card:

    python3 h100bench/calibrate.py --workload <cell> [--seeds 12]
        [--controls 3] [--first-seed N] [--batches 16] [--out PATH]

For each seed, the numbers the cell's check compares, from the program
(the lower readings), and on ``--controls`` of the seeds the same numbers
from the control: for a served cell the program's own path one precision
below the configuration's (``serve.control``) through the same pipeline
for a short window of ``--batches`` batches at the cell's batch; for a
training cell the reference computed with TF32 on in the program's place,
and the fault of half of each batch left out with the mean taken over the
rest (a step that returns its state unchanged reads 1 on ``change_gap``
by the measure's definition and needs no run). Prints one JSON line a
reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def make_run(workload: str, seed: int, device):
    import torch

    from h100bench import core

    man = core.manifest()
    cell = core.workload(man, workload)
    return core.Run(cell=cell, config=core.config(cell["config"]),
                    traffic=core.traffic(cell["traffic"]),
                    limits=core.limits(workload), seed=seed, seconds=0.0,
                    trace=False, device=torch.device(device),
                    t_start=time.perf_counter())


def served(workload, seed, variant, batches, device) -> dict:
    from h100bench import core

    r = make_run(workload, seed, device)
    core.load_module("runners", r.traffic["runner"]).run(
        r, variant=variant, batches=batches)
    return {k: v for k, (v, _) in r.compared.items()}


def trained(workload, seed, controls: bool, device) -> list:
    from h100bench import checks, trainkit

    r = make_run(workload, seed, device)
    kit = trainkit.Kit(r)
    kit.warm_up()
    kit.release()
    ref = kit.reference_side()
    out = [("program", {**kit.gaps(kit.side, ref),
                        "k1_count_gap": checks.k1_count_gap(kit.evals)})]
    if controls:
        out.append(("control_tf32", kit.gaps(kit.reference_side(tf32=True),
                                             ref)))
        out.append(("fault_half_batch",
                    kit.gaps(kit.reference_side(half=True), ref)))
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from h100bench import core

    man = core.manifest()
    cell = core.workload(man, a.workload)
    runner = core.traffic(cell["traffic"])["runner"]
    rows = []
    for i in range(a.seeds):
        seed = a.first_seed + 7 * i
        t0 = time.perf_counter()
        if runner == "label_pipeline":
            got = [("program", served(a.workload, seed, "program", a.batches,
                                      a.device))]
            if i < a.controls:
                got.append(("control", served(a.workload, seed, "control",
                                              a.batches, a.device)))
        else:
            got = trained(a.workload, seed, i < a.controls, a.device)
        for variant, vals in got:
            row = {"workload": a.workload, "seed": seed, "variant": variant,
                   **vals, "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
        if a.device.startswith("cuda"):
            torch.cuda.empty_cache()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
