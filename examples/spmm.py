#!/usr/bin/env python
"""SpMM example runner (reference: examples/spmm.cu) — CSV + validation.

    python examples/spmm.py --rows 4096 --feature-dim 128 --format bcsr \
        --impl pallas
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

from loops_tpu.formats import BCSR  # noqa: E402
from loops_tpu.io import filepath, market  # noqa: E402
from loops_tpu.ops import spmm  # noqa: E402
from loops_tpu.ops.spmm import _op_cache  # noqa: E402
from loops_tpu.utils import generate, reference  # noqa: E402
from loops_tpu.utils.bench import chained_ms_pair  # noqa: E402
from loops_tpu.utils.equal import count_mismatches  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--market")
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=2048)
    p.add_argument("--sparsity", type=float, default=0.01)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--schedule", default="row_mapped")
    p.add_argument("--format", default="csr", choices=["csr", "bcsr"])
    p.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    p.add_argument("--validate", action="store_true")
    args = p.parse_args(argv)

    if args.market:
        csr = market.load_csr(args.market)
        dataset = filepath.extract_dataset(args.market)
    else:
        csr = generate.random_csr(args.rows, args.cols, args.sparsity)
        dataset = "random"
    mat = BCSR.from_csr(csr, 8, 128) if args.format == "bcsr" else csr

    rng = np.random.default_rng(1)
    B = rng.normal(size=(csr.shape[1], args.feature_dim)).astype(np.float32)
    from loops_tpu.ops.spmm import SpMMOperator
    op = SpMMOperator(mat, schedule=args.schedule, impl=args.impl)
    C = np.asarray(op(B))

    import jax.numpy as jnp
    elapsed = chained_ms_pair(op._fn, jnp.asarray(B), iters=5)
    gflops = 2 * csr.nnz * args.feature_dim / (elapsed * 1e-3) / 1e9

    kernel = f"spmm_{args.format}_{args.schedule}" + (
        "_pallas" if args.impl == "pallas" else "")
    print(f"{kernel},{dataset},{csr.shape[0]},{csr.shape[1]},{csr.nnz},"
          f"{elapsed:.5f},{gflops:.1f}")
    if args.validate:
        errors = count_mismatches(C, reference.spmm(csr, B))
        print(f"Errors: {errors}")
        return 1 if errors else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
