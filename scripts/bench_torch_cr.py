#!/usr/bin/env python3
"""Time the port's cyclic-reduction kernel on one NVIDIA GPU.

    python3 scripts/bench_torch_cr.py [--package-root DIR] [--shapes cheetah,long]
                                      [--out FILE.json]

For each shape and batch it prints one JSON line with the kernel's time on
packed inputs (``solve_tridiag_kernel``), the time of ``solve_many`` (pack,
kernel, unpack: what a solve iteration pays) and the kernel's largest
relative difference from a dense float64 solve.  Times are medians of CUDA
event timings on the current stream.

``--package-root`` names a directory that holds another checkout's
``idto_tpu_torch`` package (for example the parent commit unpacked by
``git archive``), so that two versions can be timed in one run on one
card: run the script once for each root, in turns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = {
    # name: (n block rows, k, batches)
    "cheetah": (21, 19, (1, 256, 4096)),
    "long": (161, 19, (1, 64)),
    "longer": (641, 19, (1, 16)),
    "runtime_k": (21, 5, (256,)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=None,
                    help="directory holding the idto_tpu_torch to time "
                         "(default: this checkout)")
    ap.add_argument("--shapes", default="cheetah")
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--team", type=int, default=None,
                    help="warps that share one system (default: the "
                         "kernel's own choice)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # The package comes from --package-root; the timing and system helpers
    # always from this checkout's chip_smoke.py.
    sys.path.insert(0, here)
    from chip_smoke import cuda_time_ms, random_spd_penta

    sys.path.insert(0, os.path.abspath(args.package_root or here))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from idto_tpu_torch.ops import cr_kernel, penta

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cr_kernel.build()
    for line in cr_kernel.build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(line.strip(), file=sys.stderr)
    dtype = getattr(torch, args.dtype)
    opts = {} if args.team is None else {"team": args.team}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for name in args.shapes.split(","):
        n, k, batches = SHAPES[name]
        for batch in batches:
            H = random_spd_penta(batch, n, k, dtype, gen)
            rhs = torch.randn((batch, 1, n, k), generator=gen,
                              dtype=torch.float64, device="cuda").to(dtype)
            packed = cr_kernel._pack(H, rhs)
            x = cr_kernel._unpack(
                cr_kernel.solve_tridiag_kernel(*packed, **opts), n, k)
            nd = min(batch, 8)
            dense = penta.to_dense(H.to(dtype=torch.float64))[:nd]
            xd = torch.linalg.solve(
                dense, rhs[:nd].double().reshape(nd, 1, -1).transpose(1, 2)
            ).transpose(1, 2).reshape(rhs[:nd].shape)
            err = float((x[:nd].double() - xd).abs().max() / xd.abs().max())
            k_ms = cuda_time_ms(
                lambda: cr_kernel.solve_tridiag_kernel(*packed, **opts), args.reps)
            path_ms = cuda_time_ms(lambda: cr_kernel.solve_many(H, rhs),
                                   args.reps)
            k2_ms = cuda_time_ms(
                lambda: cr_kernel.solve_tridiag_kernel(*packed, **opts), args.reps)
            row = {"tag": args.tag, **opts, "shape": name, "n": n, "k": k,
                   "batch": batch, "dtype": args.dtype,
                   "packed_rows": int(packed[1].shape[1]),
                   "kernel_ms": [k_ms, k2_ms], "path_ms": path_ms,
                   "rel_err_vs_dense": err, "card": smi}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del H, rhs, packed, x, dense, xd
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
