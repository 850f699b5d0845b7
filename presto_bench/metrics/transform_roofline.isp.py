"""transform_roofline.isp: the fused Transform kernels' floors over their
device time, in percent.  A kernel's floor is the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s, at the shapes one partition
needs (``counts.transform_kernel_costs``); the share is the floors of every
traced launch of ``fused_dense``, ``fused_sparse`` and ``fused_gen`` over
their summed device time."""

import re

from presto_bench.harness import counts


def read(ctx):
    tv = ctx.get("trace")
    if tv is None:
        return None
    rows = ctx["data"]["rows_per_partition"]
    costs = counts.transform_kernel_costs(ctx["data"], rows, ctx["dup_factor"])
    floor = spent = 0.0
    for kernel, cost in costs.items():
        # "(anonymous namespace)::fused_dense_kernel(uint4 const*, ...)"
        pattern = re.compile(rf"(^|::){kernel}_kernel\(")

        def match(name, p=pattern):
            return p.search(name) is not None
        n = tv.count(match, cats=("kernel",))
        floor += n * counts.floor_s(cost)
        spent += tv.time_s(match, cats=("kernel",))
    return floor / spent * 100 if spent > 0 else None
