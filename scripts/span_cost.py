"""The host cost of one span of the port's tracing (``utils/profiler.py``):
a span entered and left ``--n`` times, ``--repeats`` times, printed in
microseconds a span, one line a repeat.

    python scripts/span_cost.py --n 200000 --repeats 5
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from deep_image_matching_tpu_torch.utils import profiler  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    for _ in range(args.repeats):
        profiler.reset()
        t0 = time.perf_counter()
        for _ in range(args.n):
            with profiler.span("sync.result"):
                pass
        print(f"{1e6 * (time.perf_counter() - t0) / args.n:.3f} us a span")
    profiler.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
