"""shard_serial_ms (IVF search, knn/ivf.py): the first card's device ms a
job before the other cards have work, averaged over the window's jobs:
knn_ivf.last's serial_ms on the sharded route, the first card's stream
from the start of its normalize step to the end of the rows' and buckets'
copies to the other cards (normalize, k-means, probes, members,
replicate), timed by CUDA events that the program records only while a
profiler runs. None on another route or where the record lacks it."""


def read(ctx):
    if ctx.route != "ivf_sharded":
        return None
    ms = [s["serial_ms"] for s in ctx.ivf if "serial_ms" in s]
    return sum(ms) / len(ms) if ms else None
