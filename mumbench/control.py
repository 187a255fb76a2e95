"""The benchmark's control: the reference with one guarantee broken, put in
the program's place and judged as run.py judges the program.

    python mumbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--device cuda:0]

For each seed it generates the cell's collection, works out the reference's
match set (mumbench/reference.py) and the control's: the same reference
with the left-maximality condition dropped, which breaks the guarantee that
every match is maximal. It prints one JSON line a seed with both match
counts, the seconds each took, and `mismatched_matches`, the number that
run.py compares against its limit of 0. The control must read above the
limit on every seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def control_reading(workload: str, seed: int, device: str,
                    config_override: dict = None) -> dict:
    import reference
    spec = run.cell_spec(workload)
    config = dict(spec["config"], **(config_override or {}))
    docs = run.generate(config, seed % 2**64)
    kw = run.reference_options(config, spec["mix"])
    t0 = time.perf_counter()
    want = reference.match_set(docs, device=device, **kw)
    t1 = time.perf_counter()
    ctl = reference.match_set(docs, device=device, left_maximal=False, **kw)
    t2 = time.perf_counter()
    return {"workload": workload, "seed": seed,
            "reference_matches": len(want), "reference_s": t1 - t0,
            "control_matches": len(ctl), "control_s": t2 - t1,
            "mismatched_matches": run.mismatches(ctl, want), "limit": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_reading(args.workload, seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
