"""python -m hebench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (in the current directory) on the CUDA
card and prints the result as the last line of standard output."""

import time

STARTED = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402


def main(argv=None) -> int:
    from hebench import harness

    return harness.main(argv, STARTED)


if __name__ == "__main__":
    sys.exit(main())
