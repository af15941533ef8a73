"""Entry point: python3 -m perfbench --workload ... (see perfbench/run.py)."""

import os
import sys
import time

T_START = time.monotonic()  # set-up is timed from here, before any import

if __name__ == "__main__":
    from perfbench.run import main

    code = main(sys.argv[1:], t_start=T_START)
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread and process of the run has been stopped and joined by
    # now; leave without the interpreter's teardown, so that no library's
    # exit handler runs while the CUDA context is being destroyed
    os._exit(code)
