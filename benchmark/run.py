"""Entry point: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``harness.py``).  The set-up clock
starts here, before PyTorch and the program are imported."""

import time

T_START = time.perf_counter()


def _main() -> int:
    from benchmark import harness

    return harness.main(t_start=T_START)


if __name__ == "__main__":
    raise SystemExit(_main())
