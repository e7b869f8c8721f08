"""FEDRANN in PyTorch and CUDA: long-read overlap detection on one NVIDIA GPU.

The port of `fedrann_tpu` (the JAX package, which stays the reference). It
keeps the JAX package's module names, CLI flags, `overlaps.tsv` contract,
sampling hash and SRP stream. Plain tensor code is PyTorch; the stages that
the JAX package wrote as Pallas kernels run as hand-written CUDA kernels
(`csrc/`), each with a plain PyTorch version beside it that CPU tensors take.

This package imports torch and numpy, never jax or fedrann_tpu.
"""

__version__ = "0.1.0"
__description__ = (
    "Long-read overlap detection via k-mer features, random-projection "
    "embeddings and exact cosine k-NN (PyTorch + CUDA port)."
)
