# Hand-written CUDA kernels for the fused ISP chains of the PreSto Transform
# (csrc/fused.cu), their bindings (fused.py), the public wrappers that pad and
# dispatch by device (ops.py) and the plain PyTorch versions (ref.py).
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (
    fused_dense,
    fused_gen,
    fused_sparse,
    regroup_bitpack,
    regroup_bytesplit,
)

# -- op -> kernel registry -----------------------------------------------------
# Consulted by the opgraph lowering (repro_torch.core.opgraph), under the same
# kind strings as the JAX package: FUSED_KERNELS maps a chain of operator kinds
# (one column family's decode->transform chain) to the single kernel that
# executes the whole chain in one device-memory round trip — a chain is
# ISP-fusable iff its kind tuple has an entry here.
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
    "ROW_LOCAL_KINDS",
    "fused_dense",
    "fused_gen",
    "fused_sparse",
    "ops",
    "ref",
    "regroup_bitpack",
    "regroup_bytesplit",
]
