"""Block-sparse (BCSR) SpMM as a Pallas kernel for the GPU (Triton route).

One program handles one (block row, feature tile). It walks the block
row's stored blocks; for each it loads the ``R x C`` payload and the
contiguous ``B[bcol*C : (bcol+1)*C, ftile]`` slab and issues one dot
with f32 accumulation in registers:

    acc[RP, FT] += A_blk[RP, C] @ B[bcol*C : bcol*C + C, ftile]

so the gathered ``[num_blocks, C, F]`` array that the plain einsum path
materialises is never written (reference analog: the per-row atom loop
of algorithms/spmm/thread_mapped.cuh:32-53, with a block as the atom).
Tensor-core dots need 16 rows; a block of ``R < 16`` rows is loaded
into a 16-row tile whose extra rows are masked to zero.

Precision: ``dtype=None`` asks for an IEEE f32 dot
(``Precision.HIGHEST``), since the op promises f32 results and TF32 is
the card's default. ``dtype="bfloat16"`` streams A and B in bf16 with
f32 accumulation.
"""
from __future__ import annotations

import functools

import numpy as np


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def bcsr_spmm_pallas(bcsr, block_f: int = 128, dtype=None):
    """Build ``(bufs, fn(bufs, B))`` for a BCSR matrix (C a power of two
    of at least 16)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from loops_tpu.utils.platform import pallas_interpret

    interpret = pallas_interpret()
    R, C = bcsr.block_shape
    if C < 16 or C != _next_pow2(C):
        raise ValueError(
            f"BCSR SpMM kernel needs a power-of-two C >= 16, got {R}x{C}")
    RP = max(_next_pow2(R), 16)
    rows, cols_n = bcsr.shape
    nbr = bcsr.num_block_rows
    ncols_pad = bcsr.num_block_cols * C
    stream = jnp.dtype(dtype) if dtype is not None else jnp.float32
    precision = (jax.lax.Precision.HIGHEST if dtype is None
                 else jax.lax.Precision.DEFAULT)

    # payload rows stacked [nb*R (+RP pad), C]: a block's 16-row tile
    # may read past its R rows, so every tile stays in bounds
    nb = bcsr.num_blocks
    a2d = np.zeros((nb * R + RP, C), np.float32)
    a2d[: nb * R] = np.asarray(bcsr.vals, np.float32).reshape(nb * R, C)
    bufs = dict(a=jnp.asarray(a2d, stream),
                ptr=jnp.asarray(bcsr.block_offsets.astype(np.int32)),
                bcol=jnp.asarray(bcsr.block_cols.astype(np.int32)))

    def kernel(FT, ptr_ref, bcol_ref, a_ref, b_ref, out_ref):
        br = pl.program_id(0)
        f0 = pl.program_id(1) * FT
        live = (jax.lax.broadcasted_iota(jnp.int32, (RP, C), 0) < R)

        def body(k, acc):
            bc = bcol_ref[k]
            a = plgpu.load(a_ref.at[pl.ds(k * R, RP), pl.ds(0, C)],
                           mask=live, other=0.0)
            bt = b_ref[pl.ds(bc * C, C), pl.ds(f0, FT)]
            return acc + jnp.dot(a, bt, precision=precision,
                                 preferred_element_type=jnp.float32)

        acc = jax.lax.fori_loop(ptr_ref[br], ptr_ref[br + 1], body,
                                jnp.zeros((RP, FT), jnp.float32))
        keep = jax.lax.broadcasted_iota(jnp.int32, (RP, FT), 0) < R
        plgpu.store(out_ref.at[pl.ds(br * R, RP), pl.ds(f0, FT)], acc,
                    mask=keep)

    def fn(b, B):
        F = B.shape[1]
        FT = min(_next_pow2(block_f), max(_next_pow2(F), 16))
        Fp = -(-F // FT) * FT
        Bp = jnp.zeros((ncols_pad, Fp), stream).at[:cols_n, :F].set(
            B.astype(stream))
        out = pl.pallas_call(
            functools.partial(kernel, FT),
            grid=(nbr, Fp // FT),
            out_shape=jax.ShapeDtypeStruct((nbr * R + RP, Fp), jnp.float32),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=4,
                                                 num_stages=3),
            interpret=interpret,
            name="bcsr_spmm",
        )(b["ptr"], b["bcol"], b["a"], Bp)
        return out[:rows, :F]
    return bufs, fn
