"""ivf_pairs_per_row (IVF search, knn/ivf.py): the real (query, member)
pair scores of the rescore (knn_ivf.last's real_pair_scores, the sum over
probed clusters of queries times members) over the query rows, averaged
over the window's jobs: the rescore's work, which cluster balance sets."""


def read(ctx):
    if ctx.route != "ivf" or not ctx.ivf:
        return None
    return sum(s["real_pair_scores"] for s in ctx.ivf) / (
        len(ctx.ivf) * ctx.rows)
