"""Device operators: SpMV / SpMM / SDDMM / segmented primitives."""
from loops_tpu.ops.attention import GroupedAttentionAggregate  # noqa: F401
from loops_tpu.ops.segment import (  # noqa: F401
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from loops_tpu.ops.sddmm import SDDMMOperator, sddmm  # noqa: F401
from loops_tpu.ops.spmm import SpMMOperator, spmm  # noqa: F401
from loops_tpu.ops.spmv import SpMVOperator, flat_partitioned_spmv, spmv  # noqa: F401
