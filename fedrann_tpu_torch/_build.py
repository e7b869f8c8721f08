"""Build and load the hand-written CUDA kernels in `csrc/`, and build the
host library of the native FASTX packer and TSV writer.

All `csrc/*.cu` sources compile into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds): one nvcc a source, all started at once, then one link. The
library lands in `_kernels/` beside this file (listed in .gitignore),
named by a hash of the sources, so an edited source rebuilds
and an unchanged one loads the existing build. The build happens at the
first kernel launch in a process, never at import; processes that start
together (the ranks of a multi-process run) build under one file lock,
each library into a temporary file renamed into place.

The host library is `native/fastxpack.cpp` of the repository, compiled
unchanged by g++ (`build_host`) into `_kernels/` the same way, at the
first parse or write; `io/native.py` loads it. There is no fallback: a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCE = Path(__file__).resolve().parent.parent / "native" / \
    "fastxpack.cpp"
# no -march=native: the library is built where it runs, but one build dir
# may serve hosts of different CPUs
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
HOST_LIBS = ("-lz", "-lpthread")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# C entry points of csrc/*.cu: name -> argtypes (every one returns the
# cudaError_t of its launch as an int)
_SIGNATURES = {
    # bases, aux, src, rows, length, w, k, s1, s2, threshold, keep_all,
    # out, stream
    "fk_canonical_sample": [_P, _P, _I32, _I64, _I64, _I64, _I32, _U32, _U32,
                            _U32, _I32, _P, _P],
    # bases, aux, src, rows, length, w, k, s1, s2, threshold, keep_all,
    # hit_buffer, blocked, cap, n_blocks, smem_bytes, staged, width,
    # dropped, stream
    "fk_stage_rows": [_P, _P, _I32, _I64, _I64, _I64, _I32, _U32, _U32, _U32,
                      _I32, _I64, _I32, _I32, _I32, _I32, _P, _I64, _P, _P],
    # bytes (out, one int32)
    "fk_stage_rows_static_smem": [_P],
    # slots, rows, w, blocked, cap, n_blocks, n_surv, chunk, n_chunks,
    # width, surv, buf_a, buf_b, cand, kept, staged, dropped, stream
    "fk_select_stage_long": [_P, _I64, _I64, _I32, _I32, _I32, _I64, _I32,
                             _I32, _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    # staged, rows, h, lib, lib_size, signs, n_words, mags, d, targets,
    # out, n_hits, start, n_buckets, stream
    "fk_membership_embed": [_P, _I64, _I64, _P, _I64, _P, _I64, _P, _I64,
                            _P, _P, _P, _P, _I64, _P],
    # staged, rows, h, lib, lib_size, table, is_bf16, d, targets, out,
    # n_hits, start, n_buckets, hits, bnd, done, g, parts, per, ws, nw, lag,
    # stream
    "fk_membership_embed_dense": [_P, _I64, _I64, _P, _I64, _P, _I32, _I64,
                                  _P, _P, _P, _P, _I64, _P, _P, _P, _I32,
                                  _I32, _I32, _I64, _I32, _I32, _P],
    # knn_merge.cu: q, m, c, n, d, is_bf16, fp32, first, ids, run, w, W,
    # out, vec, units, parts, stream
    "fk_knn_merge": [_P, _I64, _P, _I64, _I64, _I32, _I32, _I64, _P, _P,
                     _I64, _I64, _P, _I32, _I64, _P, _P],
    # ivf_rescore.cu: rows, d (the rows' pitch), is_bf16, member, qvals,
    # qslots, units, n_units, grid, first, n_real, p, W, buf, stream
    "fk_ivf_rescore": [_P, _I64, _I32, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                       _I64, _I64, _P, _P],
    # buf, rows, p, L, K, dedup, out, stream
    "fk_ivf_merge": [_P, _I64, _I64, _I64, _I64, _I32, _P, _P],
    # ivf_segment_sum.cu: rows, n, d, is_bf16, a, n_clusters, tile_rows,
    # n_tiles, scratch, accumulate, out, stream
    "fk_ivf_segment_sum": [_P, _I64, _I64, _I32, _P, _I64, _I64, _I64, _P,
                           _I32, _P, _P],
    # a, n, n_clusters, div, member_bounds, vals, slots, bounds, units,
    # n_units, scratch, scratch_ints, stream
    "fk_ivf_bucket": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _I64,
                      _P],
    # result_wire.cu: keys, n, u16_dist, u16_idx, idx, dist, stream
    "fk_keys_to_host": [_P, _I64, _I32, _I32, _P, _P, _P],
    # bytes, out (a void**); the block
    "fk_host_alloc": [_I64, _P],
    "fk_host_free": [_P],
    # srp_signs.cu: seed_mix, lib_size, d, n_words, bound, out, stream
    "fk_srp_signs": [_U64, _I64, _I64, _I64, _I64, _P, _P],
    # seed_mix, lib_size, d, bound, mags, is_bf16, out, stream
    "fk_srp_paired": [_U64, _I64, _I64, _I64, _P, _I32, _P, _P],
    # probes.cu: n, out, stream
    "fk_probe_smem_scratch": [_I32, _P, _P],
    # x, steps, rb, hb, sums, n_sums, stream
    "fk_probe_smem_input": [_P, _I32, _I32, _I32, _P, _I32, _P],
    # q, d, idx, row, nh, rb, src_dyn, dst_dyn, accumulate, steps, e, stream
    "fk_probe_dyn_rows": [_P, _I32, _P, _P, _I32, _I32, _I32, _I32, _I32,
                          _I32, _P, _P],
    # table, n, queries, nq, out, stream
    "fk_probe_bsearch": [_P, _I32, _P, _I32, _P, _P],
    # steps, cycles (two int64), stream
    "fk_smem_chase_cycles": [_I32, _P, _P],
}


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {home}/bin and on PATH): the CUDA "
            "kernels of fedrann_tpu_torch build from csrc/ at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfedrann_kernels_{digest.hexdigest()[:16]}.so"


def _compile(so: Path, command: list[str], what: str,
             log_head: str = "") -> Path:
    """Run `command`, which writes the library to the path that follows
    its "-o", into a temporary file renamed to `so` (atomic: a concurrent
    build never sees half a file); the compiler's output, after
    `log_head`, is kept beside it as `<library>.log`. Raises RuntimeError
    with that output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        command[command.index("-o") + 1] = tmp
        proc = subprocess.run(command, capture_output=True, text=True,
                              check=False)
        log = log_head + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}):\n{log}")
        Path(str(so) + ".log").write_text(log)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on `_kernels/.lock` (flock: released when its
    holder exits, however it exits), so processes that start at once
    compile each library once and never load one that another is
    writing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_once(so: Path, command) -> Path:
    """`so`, compiled by command() under the build lock unless it exists
    (checked again once the lock is held)."""
    if so.exists():
        return so
    with _build_lock():
        if so.exists():
            return so
        return command()


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: each
    source to an object by its own nvcc, all at once, then one link; the
    compilers' output (ptxas register and shared-memory use) is kept
    beside it as `<library>.log`."""
    so = library_path()

    def compile_all() -> Path:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cu = sorted(_CSRC.glob("*.cu"))
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in cu]
            procs = [subprocess.Popen(
                [_nvcc(), *flags, "-c", "-I", str(_CSRC), "-o", obj,
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(cu, objs)]
            logs, failed = [], []
            for src, proc in zip(cu, procs):
                out, _ = proc.communicate()
                logs.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
            head = "\n".join(logs) + "\n"
            if failed:
                raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                                   f"{head}")
            return _compile(so, [_nvcc(), "-shared", "-o", "", *objs],
                            "nvcc (link)", head)

    return _build_once(so, compile_all)


def host_library_path(source: Path = HOST_SOURCE) -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS + HOST_LIBS).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"libfastxpack_{digest.hexdigest()[:16]}.so"


def build_host(source: Path = HOST_SOURCE) -> Path:
    """Compile the host library (native/fastxpack.cpp) with g++ into
    `_kernels/` unless the build of this source exists."""
    so = host_library_path(source)

    def compile_host() -> Path:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError(
                "g++ not found on PATH: the host library of "
                f"fedrann_tpu_torch builds from {source} at first use")
        return _compile(so, [cxx, *HOST_FLAGS, "-o", "", str(source),
                             *HOST_LIBS], "g++")

    return _build_once(so, compile_host)


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fk_error_string.argtypes = [ctypes.c_int]
    lib.fk_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args, device: torch.device | None = None) -> None:
    """Call C entry point `name`; raise if its launch reported an error.

    With `device` (a CUDA device: the one the launch's tensors lie on) the
    entry is called with that device current and PyTorch's current stream
    there appended as its last argument. The entries read the current
    device for their shared-memory opt-in (cudaFuncSetAttribute) and SM
    count, and launch on the stream they are given, so both must name the
    tensors' card, whichever device was current before the call. Where it
    is the current device already (the common case), the guard is one
    read of the current device."""
    fn = getattr(kernels(), name)
    if device is None:
        rc = fn(*args)
    else:
        index = _index(device)
        if torch._C._cuda_getDevice() == index:
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{kernels().fk_error_string(rc).decode()}")


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current CUDA stream on `device`: every kernel
    launches there, so it orders with the surrounding torch ops. Read on
    every call (a caller may switch streams with torch.cuda.stream), with
    the raw getter that torch's own generated kernels use: it skips the
    Stream object that torch.cuda.current_stream builds, most of the cost
    of a small probe's launch path."""
    return torch._C._cuda_getCurrentRawStream(_index(device))


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()
