"""k10_roofline (result wire, knn/topk.py result_wire ->
csrc/result_wire.cu): the result's bytes (8 an entry: the int32 index and
the float32 distance) over PCIe Gen5 x16's nominal 63.0 GB/s, times the
keys_to_host_kernel launches the trace kept, over their device time, in
%."""

from portbench.work import k10_seconds


def read(ctx):
    kept = ctx.trace.kernels("keys_to_host_kernel")
    spent = sum(b - a for _, a, b in kept)
    if not kept or spent <= 0 or "_" in ctx.route:
        return None  # a streamed or sharded search writes slabs
    return 100.0 * k10_seconds(ctx.rows, ctx.k) * len(kept) / spent
