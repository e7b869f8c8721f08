"""k6_roofline (IVF rescore kernel, knn/ivf.py -> csrc/ivf_rescore.cu):
the least time of a job's K6 launch (the larger of 2 d operations a real
pair score, knn_ivf.last's real_pair_scores, over the peak of its
precision, and its query gathers plus its buffer over the memory peak),
averaged over the window's jobs, times the ivf_rescore_kernel launches the
trace kept, over their device time, in %."""

from portbench.work import k6_seconds


def read(ctx):
    if ctx.route != "ivf" or not ctx.ivf:
        return None
    kept = ctx.trace.kernels("ivf_rescore_kernel")
    spent = sum(b - a for _, a, b in kept)
    if not kept or spent <= 0:
        return None
    least = sum(k6_seconds(s["real_pair_scores"], ctx.rows, s["probes"],
                           ctx.d, ctx.k, ctx.precision)
                for s in ctx.ivf) / len(ctx.ivf)
    return 100.0 * least * len(kept) / spent
