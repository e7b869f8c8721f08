#!/usr/bin/env python3
"""The k-NN result wire (keys_to_host) on one card: where the plain
version's time goes, and K10's two designs beside it.

    python3 tools/wire_split.py [--port DIR]

At 11b's result (262,144 x 50 keys, f32 wire, int32 indices) and phase
4's (15,000 x 50, u16 wire, uint16 indices), from keys of seeded scores
(the decode's cost does not depend on the values):
  - keys_to_host_plain split into its steps, each between synchronizes on
    the host clock: the empty mask and its host sync, the decode (device
    ops), the u16 quantizing, the pageable .cpu() copies and the host's
    numpy passes (widening, dequantizing);
  - K10 two ways, in turns: the kernel writing the final values into
    page-locked host memory (keys_to_host as shipped), and the kernel
    writing them into a device buffer followed by one non_blocking copy_
    into page-locked memory (the design not kept: this tool builds it,
    csrc/result_wire.cu's launch behind an entry of its own that takes
    device pointers, with its own nvcc); each call's host time, the
    kernel's event time, a pinned copy_ of the same 8 bytes an entry alone
    (the floor), and a page-locked allocation of the result's size cold
    and cached;
With --port, another checkout's fedrann_tpu_torch is timed (its
keys_to_host as it has it).
Exits non-zero where no card is visible or a kernel disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "fedrann_tpu_torch", "csrc")
# K10 writing into device memory: result_wire.cu's own launch behind an
# entry that takes device pointers
DEVICE_VARIANT = r"""
#include "result_wire.cu"
extern "C" int wire_to_device(const long long* keys, int64_t n,
                              int u16_dist, int u16_idx, int* idx,
                              float* dist, void* stream) {
  return static_cast<int>(keys_to(keys, n, u16_dist, u16_idx, idx, dist,
                                  static_cast<cudaStream_t>(stream)));
}
"""


def device_variant(tmp: str):
    """DEVICE_VARIANT built by its own nvcc and loaded."""
    from fedrann_tpu_torch import _build

    src = os.path.join(tmp, "wire_to_device.cu")
    with open(src, "w") as f:
        f.write(DEVICE_VARIANT)
    so = src[:-3] + ".so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC,
                           "-o", so, src], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"wire_split: the device variant failed:\n"
                         f"{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(so).wire_to_device
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def host_ms(fn, reps: int) -> float:
    """The least host milliseconds of `reps` calls of fn, each between
    synchronizes."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def plain_split(keys, transfer: str, n_rows: int) -> dict:
    """keys_to_host_plain's steps, each between synchronizes: host ms."""
    import numpy as np
    import torch

    from fedrann_tpu_torch.knn import topk

    split: dict = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    empty = step("empty mask + bool(.any()) sync",
                 lambda: (lambda e: (e, bool(e.any())))(
                     keys == topk.EMPTY_KEY))[0]
    scores, idx = step("decode (device ops)",
                       lambda: topk._decode_keys(keys))
    dist = step("decode (device ops)", lambda: 1.0 - scores)
    del empty
    if transfer == "u16":
        q = step("u16 quantize (device ops)",
                 lambda: (topk.quantize_dist(dist) - 32768).to(torch.int16))
        qh = step("pageable .cpu() copies", lambda: q.cpu().numpy())
        step("host numpy passes",
             lambda: topk.dequantize_dist(qh.astype(np.int32) + 32768))
    else:
        step("pageable .cpu() copies", lambda: dist.cpu().numpy())
    if topk.u16_indices(transfer, n_rows):
        i16 = step("u16 quantize (device ops)",
                   lambda: (idx - 32768).to(torch.int16))
        ih = step("pageable .cpu() copies", lambda: i16.cpu().numpy())
        step("host numpy passes", lambda: ih.astype(np.int32) + 32768)
    else:
        i32 = step("decode (device ops)", lambda: idx.to(torch.int32))
        step("pageable .cpu() copies", lambda: i32.cpu().numpy())
    return split


def wire_case(cs, label: str, rows: int, k: int, transfer: str,
              card: str, to_device) -> None:
    import numpy as np
    import torch

    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.knn import topk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(rows + k)
    scores = torch.rand((rows, k), generator=g, device=dev) * 2 - 1
    ids = torch.randint(0, rows, (rows, k), generator=g, device=dev)
    keys = topk._order_keys(scores, ids)
    n_bytes = keys.numel() * 8
    # the page-locked block of the result: the first of its size in this
    # process (cold), then from torch's cache
    t0 = time.perf_counter()
    block = torch.empty((2, rows, k), dtype=torch.int32, pin_memory=True)
    cold = (time.perf_counter() - t0) * 1e3
    del block
    t0 = time.perf_counter()
    block = torch.empty((2, rows, k), dtype=torch.int32, pin_memory=True)
    cached = (time.perf_counter() - t0) * 1e3
    plain = getattr(topk, "keys_to_host_plain", topk.keys_to_host)
    want = plain(keys, transfer, rows)
    plain_ms = host_ms(lambda: plain(keys, transfer, rows), 5)
    split = plain_split(keys, transfer, rows)
    wire = getattr(topk, "result_wire", None)
    cs.log(f"{label} keys_to_host_plain {plain_ms:.3f} ms; split "
           + "; ".join(f"{s} {v:.3f}" for s, v in split.items())
           + f" (host ms); page-locked block of {n_bytes} bytes: first "
           f"{cold:.3f} ms, cached {cached:.3f} ms [{card}]")
    if wire is None:
        return
    devbuf = torch.empty((2, rows, k), dtype=torch.int32, device=dev)
    u16 = int(transfer == "u16")
    u16_idx = int(topk.u16_indices(transfer, rows))

    def to_devbuf():
        rc = to_device(keys.data_ptr(), keys.numel(), u16, u16_idx,
                       devbuf[0].data_ptr(), devbuf[1].data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            cs.fail(f"{label}: the device variant's launch gave {rc}")

    def via_device():
        out = torch.empty((2, rows, k), dtype=torch.int32, pin_memory=True)
        to_devbuf()
        out.copy_(devbuf, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        return out[0].numpy(), out[1].view(torch.float32).numpy()

    for name, fn in (("direct", lambda: topk.keys_to_host(keys, transfer,
                                                          rows)),
                     ("via device", via_device)):
        got = fn()
        if not (np.array_equal(got[0], want[0]) and np.array_equal(
                got[1].view(np.int32), want[1].view(np.int32))):
            cs.fail(f"{label}: K10 ({name}) differs from keys_to_host_plain")
    times = {"direct": [], "via device": []}
    for _ in range(3):  # in turns: direct, device, device, direct
        for name, fn in (("direct", lambda: topk.keys_to_host(
                keys, transfer, rows)), ("via device", via_device),
                         ("via device", via_device),
                         ("direct", lambda: topk.keys_to_host(
                             keys, transfer, rows))):
            times[name].append(host_ms(fn, 3))
    ev_direct = cs.time_cuda(lambda: _build.launch(
        "fk_keys_to_host", keys.data_ptr(), keys.numel(), u16, u16_idx,
        block[0].data_ptr(), block[1].data_ptr(), device=dev), 10)
    ev_device = cs.time_cuda(to_devbuf, 10)
    copy = cs.time_cuda(lambda: block.copy_(devbuf, non_blocking=True), 10)
    pageable = torch.empty((2, rows, k), dtype=torch.int32)
    pageable_ms = cs.time_cuda(lambda: pageable.copy_(devbuf), 3)
    cs.log(f"{label} K10 byte-identical both ways; host ms a call (best of "
           f"3, 6 turns): direct into page-locked memory "
           f"{min(times['direct']):.3f} (median "
           f"{sorted(times['direct'])[3]:.3f}), via a device buffer + one "
           f"copy_ {min(times['via device']):.3f} (median "
           f"{sorted(times['via device'])[3]:.3f}); the kernel by events: "
           f"into page-locked memory {ev_direct:.4f} ms, into device "
           f"memory {ev_device:.4f} ms; a pinned non_blocking copy_ of the "
           f"{n_bytes} result bytes {copy:.4f} ms "
           f"({n_bytes / copy / 1e6:.1f} GB/s), pageable {pageable_ms:.4f} "
           f"ms; device bytes (keys read) alone {n_bytes / 3.35e9:.5f} ms; "
           f"plain {plain_ms:.3f} [{card}]")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", default=HERE)
    args = parser.parse_args()
    import importlib.util

    import torch

    sys.path.insert(0, os.path.abspath(args.port))  # its fedrann_tpu_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from fedrann_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = f"{smi.stdout.strip()}, {args.port}"
    t0 = time.perf_counter()
    _build.build()
    _build.kernels()
    cs.log(f"build {time.perf_counter() - t0:.1f} s [{card}]")
    if os.path.abspath(args.port) == HERE:
        cs.log_build("K10", "keys_to_host", card)
    from fedrann_tpu_torch.knn import topk

    with tempfile.TemporaryDirectory() as tmp:
        to_device = (device_variant(tmp) if hasattr(topk, "result_wire")
                     else None)
        for label, rows, transfer in (
                ("phase 4's result (15,000 x 50, u16)", 15_000, "u16"),
                ("11b's result (262,144 x 50, f32)", 262_144, "f32"),
                ("11b's result (262,144 x 50, u16)", 262_144, "u16")):
            wire_case(cs, label, rows, 50, transfer, card, to_device)


if __name__ == "__main__":
    main()
