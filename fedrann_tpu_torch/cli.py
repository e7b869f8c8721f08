"""Command-line interface: the same flags as `fedrann_tpu/cli.py`.

The run needs a CUDA device; without one it fails, it does
not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from fedrann_tpu_torch import __description__, __version__
from fedrann_tpu_torch.config import PipelineConfig
from fedrann_tpu_torch.logging_utils import logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fedrann-tpu-torch",
        description=__description__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-i", "--input", required=True,
                   help="Path to the input FASTQ/FASTA file (optionally .gz).")
    p.add_argument("-o", "--output-dir", required=True,
                   help="Directory to save output files.")
    p.add_argument("-k", "--kmer-size", type=int, default=16,
                   help="K-mer size for feature extraction.")
    p.add_argument("--kmer-sample-fraction", type=float, default=0.005,
                   help="Fraction of k-mers used to build the feature matrix.")
    p.add_argument("--kmer-min-multiplicity", type=int, default=2,
                   help="Minimum allowed frequency of a k-mer in all reads.")
    p.add_argument("--threads", type=int, default=1,
                   help="Host-side worker threads (the native FASTA parse).")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="Reads per device batch (default: auto-sized).")
    p.add_argument("-n", "--embedding-dimension", type=int, default=500)
    p.add_argument("--nndescent-n-trees", type=int, default=300,
                   help="Accepted for reference-CLI parity; unused (search is exact).")
    p.add_argument("--nndescent-n-neighbors", type=int, default=50,
                   help="Number of neighbors per query row.")
    p.add_argument("--seed", type=int, default=356115,
                   help="Random seed (library sampling).")
    p.add_argument("--save-feature-matrix", action="store_true",
                   help="Save embeddings to feature_matrix.npz.")
    p.add_argument("--keep-intermediates", action="store_true",
                   help="Keep stage checkpoints (library, embeddings).")
    p.add_argument("--mprof", action="store_true",
                   help="Record memory usage to mprof.dat (mprof format).")
    p.add_argument("--projection-seed", type=int, default=2094,
                   help="SRP seed.")
    p.add_argument("--projection-density", type=float, default=None,
                   help="SRP density; default 1/sqrt(n_features).")
    p.add_argument("--max-hits-per-read", type=int, default=None,
                   help="Ceiling on staged candidate hits per read "
                        "(default: auto staging width).")
    p.add_argument("--knn-precision", choices=("bf16", "fp32"), default="bf16",
                   help="Distance-matmul input precision (fp32 accumulation).")
    p.add_argument("--knn-query-tile", type=int, default=None,
                   help="Query rows per top-k tile (default: config's 512).")
    p.add_argument("--knn-candidate-tile", type=int, default=None,
                   help="Candidate columns per selection round "
                        "(default: config's 131072).")
    p.add_argument("--knn-topk-method", choices=("exact", "approx"),
                   default="exact",
                   help="Block-level top-k selection (approx runs exact here).")
    p.add_argument("--knn-shard-strategy", choices=("allgather", "ring", "ring2d"),
                   default="ring", help="Candidate movement across devices.")
    p.add_argument("--knn-method", choices=("exact", "ivf"), default="exact",
                   help="Search algorithm: exact (the default) or ivf "
                   "(a coarse k-means prefilter with an exact cosine "
                   "rescore).")
    p.add_argument("--knn-ivf-clusters", type=int, default=None)
    p.add_argument("--knn-ivf-probes", type=int, default=8)
    p.add_argument("--knn-ivf-spill", type=int, default=2)
    p.add_argument("--projection-dtype", choices=("signs", "bf16", "f32"),
                   default="signs",
                   help="Projection-table storage: 2-bit signs, or a dense "
                        "bf16/f32 paired table.")
    p.add_argument("--knn-hbm-budget", type=str, default=None,
                   help="Device-memory budget for the k-NN: past it the "
                        "matrix stays in host memory and streams (8G, 512M).")
    p.add_argument("--knn-transfer", choices=("u16", "f32"), default="u16",
                   help="Distance grid: u16 snaps to 1/32767.5 steps.")
    p.add_argument("--knn-sharded", choices=("auto", "never", "always"),
                   default="auto",
                   help="Shard the k-NN over the visible GPUs: auto = when "
                        "more than one is visible.")
    p.add_argument("--mesh-shape", type=str, default=None,
                   help="Comma-separated device-mesh shape, e.g. '2,4' = "
                        "(hosts, data) for ring2d (default: every visible "
                        "GPU on one axis).")
    p.add_argument("--window-batch", type=int, default=None,
                   help="Window positions per staging chunk "
                        "(default: config's 32M).")
    p.add_argument("--length-buckets", type=str, default="auto",
                   help="Comma-separated padded read-length buckets, or "
                        "'auto' to derive a pow2 ladder from the input.")
    p.add_argument("--import-library", type=str, default=None,
                   help="A jellyfish-dump k-mer library (>count, k-mer) to "
                        "use instead of sampling one; stages every window.")
    p.add_argument("--import-projection", type=str, default=None,
                   help="A scipy .npz precompute matrix to use as the "
                        "projection (float32).")
    p.add_argument("--no-pack-cache", action="store_true",
                   help="Do not read or write <output-dir>/fxcache.npz.")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace to <output-dir>/trace.")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Processes of a multi-process run (one per host "
                        "or card set).")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's rank in [0, --num-processes).")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for a multi-process run "
                        "(default: JAX_COORDINATOR_ADDRESS).")
    return p


def parse_bytes(s: str | None) -> int | None:
    """'8G' / '512M' / '64K' / plain bytes -> int bytes (binary units)."""
    if s is None:
        return None
    s = s.strip().upper().removesuffix("B")
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1] in units:
        return int(float(s[:-1]) * units[s[-1]])
    return int(s)


def config_from_args(argv: list[str] | None = None) -> PipelineConfig:
    args = build_parser().parse_args(argv)
    defaults = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}

    def _or_default(value, name):
        return value if value is not None else defaults[name]

    return PipelineConfig(
        input_path=args.input,
        output_dir=args.output_dir,
        kmer_size=args.kmer_size,
        kmer_sample_fraction=args.kmer_sample_fraction,
        kmer_min_multiplicity=args.kmer_min_multiplicity,
        threads=args.threads,
        chunk_size=args.chunk_size,
        embedding_dimension=args.embedding_dimension,
        n_neighbors=args.nndescent_n_neighbors,
        n_trees=args.nndescent_n_trees,
        seed=args.seed,
        save_feature_matrix=args.save_feature_matrix,
        keep_intermediates=args.keep_intermediates,
        checkpoint=args.keep_intermediates,
        mprof=args.mprof,
        projection_seed=args.projection_seed,
        projection_density=args.projection_density,
        max_hits_per_read=args.max_hits_per_read,
        knn_precision=args.knn_precision,
        knn_query_tile=_or_default(args.knn_query_tile, "knn_query_tile"),
        knn_candidate_tile=_or_default(args.knn_candidate_tile,
                                       "knn_candidate_tile"),
        knn_sharded=args.knn_sharded,
        mesh_shape=(tuple(int(x) for x in args.mesh_shape.split(","))
                    if args.mesh_shape else None),
        window_batch=_or_default(args.window_batch, "window_batch"),
        knn_topk_method=args.knn_topk_method,
        knn_shard_strategy=args.knn_shard_strategy,
        knn_method=args.knn_method,
        knn_ivf_clusters=args.knn_ivf_clusters,
        knn_ivf_probes=args.knn_ivf_probes,
        knn_ivf_spill=args.knn_ivf_spill,
        knn_transfer=args.knn_transfer,
        knn_hbm_budget=parse_bytes(args.knn_hbm_budget),
        projection_dtype=args.projection_dtype,
        length_buckets=(None if args.length_buckets == "auto"
                        else tuple(int(x)
                                   for x in args.length_buckets.split(","))),
        import_library=args.import_library,
        import_projection=args.import_projection,
        pack_cache=not args.no_pack_cache,
        profile=args.profile,
        log_level=args.log_level,
        num_processes=args.num_processes,
        process_id=args.process_id,
        coordinator=args.coordinator,
    )


def main(argv: list[str] | None = None) -> int:
    """Run the pipeline on this process's CUDA card(s) (the cards
    CUDA_VISIBLE_DEVICES shows it): one process, or this rank of a
    multi-process run where --num-processes > 1 or a coordinator
    (--coordinator, JAX_COORDINATOR_ADDRESS) is given."""
    from fedrann_tpu_torch.device import get_device
    from fedrann_tpu_torch.parallel.dist import coordinator_address

    config = config_from_args(argv)
    device = get_device("cuda")
    if (config.num_processes or 0) > 1 \
            or coordinator_address(config.coordinator):
        from fedrann_tpu_torch.parallel.runtime import run_pipeline_multihost

        result = run_pipeline_multihost(config, device)
    else:
        from fedrann_tpu_torch.pipeline import run_pipeline

        result = run_pipeline(config, device)
    logger.info("done: %d reads, %d library k-mers, output %s",
                len(result.names), result.library.size, result.overlaps_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
