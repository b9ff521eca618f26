"""The benchmark of ako_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the card(s) the cell
asks for, and prints, as the last line of its standard output, one JSON
object: correct, attempted, failed, metrics, device (and with --trace 1
breakdown), then the numbers compared with their limits. Without a card
it exits non-zero and prints no result. See portbench/README.md.
"""

import os
import sys
import time
import traceback

T0 = time.perf_counter()
# torch.profiler left up from one window to the next records fewer device
# events the longer a process has profiled; torn down after each window it
# records them all. Set before torch is imported; such a process hangs in
# its exit, so this script ends with os._exit.
os.environ.setdefault("TEARDOWN_CUPTI", "1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    try:
        from portbench.harness.main import main

        code = main(sys.argv[1:], T0, ROOT)
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
