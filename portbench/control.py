"""The check's control: the reference put in the program's place and
computed at the next precision below the codec's (int8 stores where the
codec states int16), at a cell's own size, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n,n,...>

For each seed it makes the cell's pool as a run does, takes the
control's answer for every pool image as the answers of a window that
sampled each image once, and prints the numbers the check compares
beside their limits, one JSON line a seed. The control must come out
not correct on every seed. The benchmark's own runs do not run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_numbers(config: dict, mix: dict, answer, pool: list, device) -> dict:
    """The compared numbers of the int8 control over the whole pool;
    `answer` is the loop's `reference(enc, mix)`."""
    from portbench.harness import check
    from portbench.reference import codec as ref

    control = check.Expected(config, mix, pool, device, answer, store=ref.store8)
    kept = [(k, control(k)) for k in range(len(pool))]
    return check.compare(kept, 0, check.Expected(config, mix, pool, device, answer))


def main() -> int:
    import torch

    from portbench.harness import check
    from portbench.harness.pool import make_pool
    from portbench.harness.registry import Bench

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    for seed in map(int, args.seeds.split(",")):
        t = time.perf_counter()
        pool = make_pool(config, seed, "cuda")
        numbers = control_numbers(config, mix, bench.loop(mix["loop"]).reference, pool,
                                  torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": check.is_correct(numbers), "seconds": time.perf_counter() - t,
                          "compared": {k: {"value": v, "limit": check.LIMITS[k]}
                                       for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
