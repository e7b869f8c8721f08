"""Pipeline configuration: the same dataclass, defaults and validation as
`fedrann_tpu/config.py`, so a run of either package is described by the
same fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- Reference-compatible knobs ---
    input_path: str = ""
    output_dir: str = ""
    kmer_size: int = 16                   # -k / --kmer-size
    kmer_sample_fraction: float = 0.005   # --kmer-sample-fraction
    kmer_min_multiplicity: int = 2        # --kmer-min-multiplicity
    threads: int = 1                      # --threads (native parse workers)
    # --chunk-size: reads per device batch; None = window_batch decides
    chunk_size: Optional[int] = None
    embedding_dimension: int = 500        # -n / --embedding-dimension
    n_neighbors: int = 50                 # --nndescent-n-neighbors
    n_trees: int = 300                    # accepted for CLI parity; unused
    seed: int = 356115                    # --seed (library sampling)
    save_feature_matrix: bool = False     # --save-feature-matrix
    keep_intermediates: bool = False      # --keep-intermediates
    mprof: bool = False                   # --mprof

    # --- Native knobs ---
    projection_seed: int = 2094           # SRP stream seed
    projection_density: Optional[float] = None  # None = 1/sqrt(n_features)
    # ceiling on staged candidate occurrences per read (None = the
    # mean+6-sigma staging width is the only cap); overflow is counted
    max_hits_per_read: int | None = None
    # window positions per staging chunk: rows = window_batch // bucket length
    window_batch: int = 1 << 25
    # padded read-length buckets; None = auto_length_buckets from the input
    length_buckets: Optional[Sequence[int]] = None
    knn_query_tile: int = 512             # query rows per top-k tile
    knn_candidate_tile: int = 131072      # candidate columns per round
    knn_precision: str = "bf16"           # "bf16" (fp32 accumulation) | "fp32"
    knn_shard_strategy: str = "ring"      # multi-device only
    knn_topk_method: str = "exact"        # "approx" runs exact selection here
    knn_method: str = "exact"             # "exact" | "ivf" (knn/ivf.py)
    knn_ivf_clusters: Optional[int] = None
    knn_ivf_probes: int = 8
    knn_ivf_spill: int = 2
    knn_sharded: str = "auto"
    knn_hbm_budget: Optional[int] = None  # out-of-core valve (bytes)
    knn_transfer: str = "u16"             # distance snapping grid: u16 | f32
    projection_dtype: str = "signs"       # "signs" | "bf16" | "f32" (dense)
    profile: bool = False
    checkpoint: bool = False
    mesh_shape: Optional[Sequence[int]] = None
    pack_cache: bool = True
    import_library: Optional[str] = None
    import_projection: Optional[str] = None
    log_level: str = "INFO"
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    coordinator: Optional[str] = None

    @property
    def k(self) -> int:
        return self.kmer_size

    def __post_init__(self):
        if not (1 <= self.kmer_size <= 31):
            raise ValueError(f"kmer_size must be in [1, 31], got {self.kmer_size}")
        if not (0.0 < self.kmer_sample_fraction <= 1.0):
            raise ValueError("kmer_sample_fraction must be in (0, 1]")
        if self.embedding_dimension < 1:
            raise ValueError("embedding_dimension must be >= 1")
        if self.knn_precision not in ("bf16", "fp32"):
            raise ValueError("knn_precision must be 'bf16' or 'fp32'")
        if self.knn_shard_strategy not in ("allgather", "ring", "ring2d"):
            raise ValueError(
                "knn_shard_strategy must be 'allgather', 'ring', or 'ring2d'")
        if self.knn_sharded not in ("auto", "never", "always"):
            raise ValueError("knn_sharded must be 'auto', 'never', or 'always'")
        if self.knn_transfer not in ("u16", "f32"):
            raise ValueError("knn_transfer must be 'u16' or 'f32'")
        if self.projection_dtype not in ("signs", "bf16", "f32"):
            raise ValueError(
                "projection_dtype must be 'signs', 'bf16' or 'f32'")
        if self.knn_topk_method not in ("exact", "approx"):
            raise ValueError("knn_topk_method must be 'exact' or 'approx'")
        if self.knn_method not in ("exact", "ivf"):
            raise ValueError("knn_method must be 'exact' or 'ivf'")
        if self.knn_ivf_probes < 1:
            raise ValueError("knn_ivf_probes must be >= 1")
        if self.knn_ivf_spill < 1:
            raise ValueError("knn_ivf_spill must be >= 1")
        if self.knn_hbm_budget is not None and self.knn_hbm_budget < (1 << 20):
            raise ValueError("knn_hbm_budget must be at least 1 MiB")
