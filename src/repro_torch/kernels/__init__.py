# Hand-written CUDA kernels for the PreSto Transform (csrc/: the fused ISP
# chains in fused.cu, the standalone passes of the host lowering in decode.cu,
# sigridhash.cu, bucketize.cu and lognorm.cu, their shared device functions
# in common.cuh), their bindings (fused.py, decode.py, sigridhash.py,
# bucketize.py, lognorm.py over _binding.py), the public wrappers that pad
# and dispatch by device (ops.py) and the plain PyTorch versions (ref.py).
# The standalone wrappers stay under ``ops`` (ops.sigridhash, ops.bucketize,
# ops.lognorm): re-exported here they would hide the binding modules of the
# same names.
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (
    decode_bitpack,
    decode_bytesplit,
    decode_lengths,
    fused_dense,
    fused_gen,
    fused_sparse,
    regroup_bitpack,
    regroup_bytesplit,
)

# -- op -> kernel registry -----------------------------------------------------
# Consulted by the opgraph lowering (repro_torch.core.opgraph), under the same
# kind strings as the JAX package: OP_KERNELS maps a single operator kind to
# its standalone pass; FUSED_KERNELS maps a chain of operator kinds (one
# column family's decode->transform chain) to the single kernel that executes
# the whole chain in one device-memory round trip — a chain is ISP-fusable
# iff its kind tuple has an entry here.
OP_KERNELS = {
    "decode.bytesplit": decode_bytesplit,
    "decode.bitpack": decode_bitpack,
    "decode.lengths": decode_lengths,
    "bucketize": ops.bucketize,
    "sigridhash": ops.sigridhash,
    "lognorm": ops.lognorm,
}

FUSED_KERNELS = {
    ("decode.bytesplit", "lognorm"): fused_dense,
    ("decode.bitpack", "sigridhash"): fused_sparse,
    ("decode.bytesplit", "bucketize", "sigridhash"): fused_gen,
}

# Operator kinds whose output at row r depends ONLY on input values of row r.
# Stacking K partitions along the row axis and running ONE launch is bitwise
# identical to K solo launches iff every lowered stage kind is row-local
# (``core.opgraph.LoweredPlan.megabatch_safe``).
ROW_LOCAL_KINDS = frozenset(
    {
        "decode.bytesplit",
        "decode.bitpack",
        "decode.lengths",
        "decode.labels",
        "bucketize",
        "sigridhash",
        "lognorm",
        "formbatch",  # pure per-row reshapes/transposes
    }
    | {"fused:" + "+".join(kinds) for kinds in FUSED_KERNELS}
)

__all__ = [
    "FUSED_KERNELS",
    "OP_KERNELS",
    "ROW_LOCAL_KINDS",
    "decode_bitpack",
    "decode_bytesplit",
    "decode_lengths",
    "fused_dense",
    "fused_gen",
    "fused_sparse",
    "ops",
    "ref",
    "regroup_bitpack",
    "regroup_bytesplit",
]
