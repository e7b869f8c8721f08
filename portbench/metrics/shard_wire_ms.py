"""shard_wire_ms (result wire, knn/topk.py result_wire,
csrc/result_wire.cu): the host's ms a job from the first card's take of
page-locked memory to the result concatenated in host memory, averaged
over the window's jobs: 1000 wire_s of knn_ivf.last on the sharded route
(each card's K10 call in turn, its take, launch and wait, then the
concatenation of the cards' parts), read only while a profiler runs.
None on another route or where the record lacks it."""


def read(ctx):
    if ctx.route != "ivf_sharded":
        return None
    ms = [1000.0 * s["wire_s"] for s in ctx.ivf if "wire_s" in s]
    return sum(ms) / len(ms) if ms else None
