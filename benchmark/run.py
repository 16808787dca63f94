#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are named in
``BENCHMARK.json`` at the root of the checkout (``benchmark/README.md``).
The run needs the CUDA cards the cell asks for and fails without them; it
drives ``idto_tpu_torch`` and never the JAX package, and fails if any JAX
module was loaded.  The last line of standard output is one JSON object;
the numbers the correctness check compared, each beside its limit, are
the last lines of standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Build and kernel caches of the program stay at fixed paths in the
# checkout, so that only a cell's first run there builds.
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from yardstick import card, imports, manifest, runner

    cell = manifest.Manifest(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, lines = runner.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_PROCESS)
    found = imports.forbidden_modules()
    if found:
        print("JAX modules were loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    print(f"card: {card.nvidia_smi()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
