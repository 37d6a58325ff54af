#!/usr/bin/env python
"""SpMV example runner — CSV timing line + validation.

Parity with the reference example binaries (reference: examples/spmv/*.cu
+ helpers.hxx:40-143): loads a Matrix Market file (or generates a random
matrix), runs the chosen kernel, prints the
``kernel,dataset,rows,cols,nnzs,elapsed`` CSV line, and with
``--validate`` / ``--rigorous`` prints the Errors / Wilkinson-verdict
blocks.

    python examples/spmv.py -m datasets/chesapeake.mtx \
        --schedule merge_path --validate --rigorous
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache,
    ensure_platform,
)

ensure_platform()
enable_compilation_cache()

from loops_tpu.formats import BCSR, CSC, DIA, ELL  # noqa: E402
from loops_tpu.io import filepath, market  # noqa: E402
from loops_tpu.ops import spmv  # noqa: E402
from loops_tpu.utils import generate, reference  # noqa: E402
from loops_tpu.utils.bench import chained_ms_pair  # noqa: E402
from loops_tpu.utils.equal import count_mismatches  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--market", help="Matrix Market file")
    p.add_argument("--rows", type=int, default=1024)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--sparsity", type=float, default=0.01)
    p.add_argument("--schedule", default="merge_path",
                   choices=["row_mapped", "group_mapped", "work_oriented",
                            "merge_path", "auto"])
    p.add_argument("--format", default="csr",
                   choices=["csr", "csc", "coo", "ell", "bcsr", "dia",
                            "auto"])
    p.add_argument("--block", type=int, default=512)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--rigorous", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.market:
        csr = market.load_csr(args.market)
        dataset = filepath.extract_dataset(args.market)
    else:
        csr = generate.random_csr(args.rows, args.cols, args.sparsity)
        dataset = "random"

    if args.format == "auto":
        from loops_tpu.formats import advise
        adv = advise(csr)
        args.format = adv.recommended
        print(f"Advisor: {adv.recommended} — {adv.why}", file=sys.stderr)

    mat = {
        "csr": lambda: csr,
        "coo": lambda: csr.to_coo(),
        "csc": lambda: CSC.from_csr(csr),
        "ell": lambda: ELL.from_csr(csr),
        "bcsr": lambda: BCSR.from_csr(csr, 8, 128),
        "dia": lambda: DIA.from_csr(csr),
    }[args.format]()

    # single-strategy formats implement row_mapped only (the operator
    # rejects knobs it would otherwise silently ignore); coerce the CLI
    # default with a notice
    if args.format in ("csc", "dia", "bcsr") and args.schedule != "row_mapped":
        print(f"note: {args.format} implements row_mapped only; "
              f"overriding --schedule {args.schedule}", file=sys.stderr)
        args.schedule = "row_mapped"

    x = generate.make_input_vector(csr.shape[1])
    y = np.asarray(spmv(mat, x, schedule=args.schedule, block=args.block))

    import jax.numpy as jnp
    from loops_tpu.ops.spmv import _op_cache
    op = _op_cache(mat)[(args.schedule, args.block)]
    elapsed = chained_ms_pair(op._fn, jnp.asarray(x), iters=10)

    kernel = f"{args.format}_{args.schedule}"
    print(f"{kernel},{dataset},{csr.shape[0]},{csr.shape[1]},{csr.nnz},"
          f"{elapsed:.5f}")

    status = 0
    if args.validate or args.rigorous:
        y_ref = reference.spmv(csr, x)
        errors = count_mismatches(y, y_ref, verbose=args.verbose)
        print(f"Matrix: {dataset}")
        print(f"Dimensions: {csr.shape[0]} x {csr.shape[1]} "
              f"({csr.nnz} nnz)")
        print(f"Errors: {errors}")
        status = 1 if errors else 0
    if args.rigorous:
        rep = reference.rigorously_validate_spmv(csr, x, y)
        print(f"WilkinsonK: {rep.wilkinson_k}")
        print(f"NaiveMismatches: {rep.naive_mismatches}")
        print(f"F32BaselineOverruns: {rep.f32_baseline_overruns}")
        print(f"GPUOverruns: {rep.kernel_overruns}")
        print(f"MaxAbsError: {rep.max_abs_error:.3e}")
        print(f"MaxRelError: {rep.max_rel_error:.3e}")
        print(f"Verdict: {rep.verdict}")
        status = status or (rep.verdict != "NOT_A_BUG")
    return status


if __name__ == "__main__":
    sys.exit(main())
