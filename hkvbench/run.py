"""Run one cell of the benchmark of `repro_torch` once.

    python3 hkvbench/run.py --workload hkv_b.find_zipf --seed 7 --seconds 10 --trace 0

From the root of a checkout that holds `src/repro_torch`.  The last line
of standard output is the result as one JSON object; the numbers the
comparison with the reference judged, each beside its limit, are the last
lines of standard error and the result's last key.  Exits 2, printing no
result, without a CUDA device (or fewer than the cell asks for) or
without the program; 3 where JAX or the JAX package got loaded.
`--control bfloat16` builds the program's table with bfloat16 value
planes: the comparison's control, which has to come out not correct.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None)
    args = p.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no program: {src / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    # the kernels' build cache at a fixed path inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(src / "repro_torch" / ".build")
    sys.path[:0] = [str(src), str(ROOT)]

    import torch

    from hkvbench import harness, roofline

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), STARTED, args.control)
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"the run loaded {', '.join(forbidden)}: the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    print(f"peaks: HBM {roofline.HBM_BYTES_PER_S:.3e} B/s, host link "
          f"{roofline.LINK_BYTES_PER_S:.3e} B/s a direction; card: {roofline.power_limit()}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
