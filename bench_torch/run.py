"""The port's benchmark: one cell of ``BENCHMARK.json`` per run.

    python3 bench_torch/run.py --workload kalbar801-nuts --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with an NVIDIA GPU.  It
builds the cell's configuration from its seed, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last (``harness.py``).  ``--rehearse
R`` runs the same on the CPU at (2R+1)² cells, for the tests; its line
says ``"platform": "cpu"`` and is no measurement.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T0))
