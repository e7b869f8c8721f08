"""job_mfu (search job, pipeline.search): the least time of the tensor-core
work the trace kept over the traced window's length, in %: every K4 launch
it kept (Context.k4_least) and, on the IVF route, each ivf_rescore_kernel
launch it kept at 2 d operations a real pair score (knn_ivf.last's
real_pair_scores, averaged over the window's jobs) over the peak of its
precision. A later change that takes K4 or K6 off the path silences its
roofline; this share still bounds what the whole job does with the card."""

from portbench.work import ops_seconds


def read(ctx):
    least = ctx.k4_least()
    if least is None or ctx.trace.window_s <= 0:
        return None
    if ctx.route == "ivf":
        kept = ctx.trace.kernels("ivf_rescore_kernel")
        if not ctx.ivf or not kept:
            return None
        least += len(kept) * sum(
            ops_seconds(2.0 * s["real_pair_scores"] * ctx.d, ctx.precision)
            for s in ctx.ivf) / len(ctx.ivf)
    return 100.0 * least / ctx.trace.window_s
