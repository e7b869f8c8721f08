"""ivf_kmeans_ms (IVF search, knn/ivf.py): the k-means's device time a job,
in ms, averaged over the window's jobs: knn_ivf.last's device_ms["kmeans"],
the search's stream from the end of its normalize step to the end of its
k-means (K4's assignments, K9's sums, the centroids' torch ops), timed by
CUDA events that the program records only while a profiler runs. None
where the record lacks it (the CPU, another route, a program without it)."""


def read(ctx):
    if ctx.route != "ivf":
        return None
    ms = [s["device_ms"]["kmeans"] for s in ctx.ivf
          if "kmeans" in s.get("device_ms", {})]
    return sum(ms) / len(ms) if ms else None
