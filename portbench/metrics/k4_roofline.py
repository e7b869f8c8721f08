"""k4_roofline (exact k-NN kernel, knn/topk.py -> csrc/knn_merge.cu):
the least time of the K4 launches the trace kept (Context.k4_least: 2 q c
d operations each, over the bf16 peak for knn_merge_wgmma, the float32
peak for knn_merge_ffma) over the device time of every knn_merge_* kernel,
in %. A launch scores q rows over c candidates: every row over every row
on the exact route, every row over the C centroids on the IVF route (its
k-means assignments and its probe ranking)."""


def read(ctx):
    least = ctx.k4_least()
    spent = sum(b - a for _, a, b in ctx.trace.kernels("knn_merge_"))
    if least is None or spent <= 0:
        return None
    return 100.0 * least / spent
