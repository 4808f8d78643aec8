"""The control of the comparison that decides `correct`, and the
readings its limits are set from.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

For each seed: one run of the cell with a window of one call (set-up,
the call, the check), then the control: the reference's GMM fits in
float32, the precision below the configuration's float64, put in the
program's place and held to the float64 reference by the same
`model_gap`. One JSON line a seed: the program's compared numbers (the
lower readings) and the control's `model_gap` (the upper reading). The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from . import run, spec
from .reference import gmm


def control_gap(workdir: str, out: str = "out") -> tuple[float, float, int]:
    """(model_gap of the float32 fits against the float64 ones, seconds,
    frequencies) on the program's allele frequency file."""
    t = time.time()
    af = gmm.read_frequencies(os.path.join(workdir, "PloidyFrost_output",
                                           out + "_allele_frequency.txt"))
    af = af[(af >= 0.0) & (af <= 1.0)]
    ref, _ = gmm.model_result(af, np.float64)
    low, _ = gmm.model_result(af, np.float32)
    return gmm.gap(low, ref), time.time() - t, len(af)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    cfg = spec.config(cell["config"], bench)
    traffic = spec.traffic(cell["traffic"])
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    run.log(f"card: {run.card_line()}")
    here = os.getcwd()
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="pfcontrol_", dir=base)
        try:
            r = run.run_cell(cell, cfg, traffic, seed, 0.0, False, "cuda", time.time(),
                             spec.limits(), bench, workdir)
            gap, secs, n = control_gap(workdir)
        finally:
            os.chdir(here)
            shutil.rmtree(workdir, ignore_errors=True)
        res = r["result"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "counts": r["info"]["check_counts"],
                          "control": {"model_gap": gap, "limit": spec.limits()["model_gap"],
                                      "fails": bool(gap > spec.limits()["model_gap"]),
                                      "seconds": secs, "frequencies": n}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
