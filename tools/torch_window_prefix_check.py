"""Run-to-run bits of a float prefix sum on the card: torch.cumsum of a
whole vector against exec/window.py's fixed_order_cumsum.

Sums one seeded float64 vector (--n values, 30,000,000 by default, the
size of the collection corpus's largest expansion) --runs times with
each and counts the distinct results, then times each by CUDA events
(mean of 10 calls) and gives its largest difference from torch.cumsum.
One JSON line each, then the card's name and power limit.  Run from the
repository root, on a machine with a card:

    python3 tools/torch_window_prefix_check.py [--n 30000000] [--runs 31]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30_000_000)
    ap.add_argument("--runs", type=int, default=31)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from presto_tpu_torch.exec.window import fixed_order_cumsum

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.n, device="cuda", dtype=torch.float64,
                    generator=gen) * 1e3
    plain = torch.cumsum(x, 0)
    for name, fn in (("torch.cumsum", lambda t: torch.cumsum(t, 0)),
                     ("fixed_order_cumsum", fixed_order_cumsum)):
        seen = []
        for _ in range(args.runs):
            y = fn(x)
            if not any(torch.equal(y, s) for s in seen):
                seen.append(y)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn(x)
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"prefix": name, "n": args.n, "runs": args.runs,
                          "distinct_results": len(seen),
                          "ms": start.elapsed_time(end) / 10,
                          "max_abs_diff_from_torch_cumsum": float(
                              (fn(x) - plain).abs().max())}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
