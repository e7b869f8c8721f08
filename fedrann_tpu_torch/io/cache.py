"""Packed-reads cache (`<output_dir>/fxcache.npz`): a rerun over the same
input skips the FASTX parse.

The port's copy of `fedrann_tpu/io/cache.py`, in the same v3 layout and
meta, so each package reads the other's cache. The first run saves the
bucketed 2-bit form with the names, lengths and read indices; a rerun
whose input (path, size, mtime) and bucket settings match loads it back.
Plain `np.savez` writes it (uncompressed: a load is one read).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from fedrann_tpu_torch.io.packing import PackedBucket, PackedReads
from fedrann_tpu_torch.logging_utils import logger

CACHE_VERSION = 3  # v3: each bucket's prefix_valid is saved


def cache_meta(input_path: str, length_buckets: Optional[Sequence[int]],
               split_overlap: int | None = None) -> dict:
    """Identity of the cached packing; any mismatch invalidates the cache.
    The auto ladder (length_buckets None) is a function of the input, so
    "auto" identifies it."""
    st = os.stat(input_path)
    return {
        "version": CACHE_VERSION,
        "path": os.path.abspath(input_path),
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "buckets": ("auto" if length_buckets is None
                    else [int(b) for b in length_buckets]),
        "split_overlap": split_overlap,
    }


def save_packed_cache(cache_path: str, packed: PackedReads,
                      meta: dict) -> None:
    """Write `packed` (a temporary file renamed into place)."""
    arrays: dict = {
        "meta": np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                              dtype=np.uint8),
        "names": np.frombuffer("\x00".join(packed.names).encode("latin-1"),
                               dtype=np.uint8),
        "n_truncated": np.int64(packed.n_truncated),
        "n_buckets": np.int64(len(packed.buckets)),
    }
    if packed.split_read_ids is not None:
        arrays["split_ids"] = packed.split_read_ids
    for i, b in enumerate(packed.buckets):
        arrays[f"b{i}_lengths"] = b.lengths
        arrays[f"b{i}_read_index"] = b.read_index
        arrays[f"b{i}_length"] = np.int64(b.length)
        if b.bases is not None:
            arrays[f"b{i}_bases"] = b.bases
        else:
            arrays[f"b{i}_packed"] = b.packed_bases
            arrays[f"b{i}_valid"] = b.valid_bits
            if b.prefix_valid is not None:
                arrays[f"b{i}_prefix_valid"] = np.bool_(b.prefix_valid)
    tmp = cache_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, cache_path)
    logger.info("wrote packed-reads cache %s (%.1f MB)", cache_path,
                os.path.getsize(cache_path) / 1e6)


def load_packed_cache(cache_path: str, meta: dict) -> Optional[PackedReads]:
    """The cached PackedReads if the cache exists and its meta equals
    `meta`, else None. Each load is counted in `.hits`."""
    if not os.path.exists(cache_path):
        return None
    try:
        data = np.load(cache_path)
        stored = json.loads(bytes(data["meta"]).decode())
        if stored != json.loads(json.dumps(meta, sort_keys=True)):
            logger.info("packed-reads cache %s is stale; re-parsing",
                        cache_path)
            return None
        names = bytes(data["names"]).decode("latin-1").split("\x00")
        if names == [""]:
            names = []
        buckets = []
        for i in range(int(data["n_buckets"])):
            kw = dict(lengths=data[f"b{i}_lengths"],
                      read_index=data[f"b{i}_read_index"],
                      length=int(data[f"b{i}_length"]))
            if f"b{i}_bases" in data:
                buckets.append(PackedBucket(bases=data[f"b{i}_bases"], **kw))
            else:
                buckets.append(PackedBucket(
                    bases=None, packed_bases=data[f"b{i}_packed"],
                    valid_bits=data[f"b{i}_valid"],
                    prefix_valid=(bool(data[f"b{i}_prefix_valid"])
                                  if f"b{i}_prefix_valid" in data else None),
                    **kw))
        logger.info("loaded packed-reads cache %s (%d reads)", cache_path,
                    len(names))
        load_packed_cache.hits += 1
        return PackedReads(
            names=names, buckets=buckets,
            n_truncated=int(data["n_truncated"]),
            split_read_ids=(data["split_ids"] if "split_ids" in data
                            else None))
    except (OSError, KeyError, ValueError, json.JSONDecodeError) as e:
        logger.warning("packed-reads cache %s unreadable (%s); re-parsing",
                       cache_path, e)
        return None


load_packed_cache.hits = 0
