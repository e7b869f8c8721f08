"""shard_k6_roofline (IVF rescore kernel, knn/ivf.py ->
csrc/ivf_rescore.cu) on the sharded route: the least time of a job's K6
launches, one a card that searched rows (the sum over them of
work.k6_seconds of its real pair scores and query rows, knn_ivf.last's
entry_pairs and entry_rows), averaged over the window's jobs, times the
ivf_rescore_kernel launches the trace kept (on every card) over the
launches a job makes, over the kept launches' device time, in %. None on
another route or where the record lacks the entries' counts."""

from portbench.work import k6_seconds


def read(ctx):
    if ctx.route != "ivf_sharded":
        return None
    jobs = [s for s in ctx.ivf if s.get("entry_rows")]
    kept = ctx.trace.kernels("ivf_rescore_kernel")
    spent = sum(b - a for _, a, b in kept)
    if not jobs or not kept or spent <= 0:
        return None
    least = sum(sum(k6_seconds(pairs, rows, s["probes"], ctx.d, ctx.k,
                               ctx.precision)
                    for pairs, rows in zip(s["entry_pairs"],
                                           s["entry_rows"]))
                for s in jobs) / len(jobs)
    launches = sum(len(s["entry_rows"]) for s in jobs) / len(jobs)
    return 100.0 * least * len(kept) / launches / spent
