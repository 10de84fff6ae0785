"""``python3 -m seldbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell, from the root of a checkout; the
last line of standard output is the run's result (:mod:`seldbench.harness`)."""
import time

START = time.perf_counter()  # set-up is counted from here, before torch loads

if __name__ == "__main__":
    import sys

    from seldbench.harness import main

    sys.exit(main(start=START))
