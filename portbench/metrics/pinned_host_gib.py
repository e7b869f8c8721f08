"""pinned_host_gib (result wire, knn/topk.py result_wire,
csrc/result_wire.cu): the most page-locked host memory a job held, in GiB:
the largest over the window's jobs of knn_ivf.last's pinned_bytes, read
right after the result's take (every live HostBlock and the blocks torch's
caching host allocator has handed out). None where the record lacks
it."""


def read(ctx):
    if ctx.route != "ivf":
        return None
    held = [s["pinned_bytes"] for s in ctx.ivf if "pinned_bytes" in s]
    return max(held) / float(1 << 30) if held else None
