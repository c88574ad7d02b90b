"""The store's two hand-written CUDA kernels, with their plain twins.

- ``histogram_update`` -> ``csrc/flat_histogram.cu``: replaces the TPU
  kernel ``zipkin_tpu/ops/pallas_kernels.py:flat_histogram``.
- ``arena_claim_scatter`` -> ``csrc/arena_claim_scatter.cu``: replaces
  ``zipkin_tpu/ops/pallas_kernels.py:arena_claim_scatter``.

Each wrapper takes its plain PyTorch twin ONLY for tensors on the CPU
(the tests run there). For CUDA tensors it launches its kernel or
raises; no path falls back. ``LAUNCHES`` counts kernel launches per
wrapper (the twins do not count), so a run can show the store went
through the kernels.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
plain-C shared libraries under ``build/zipkin_tpu_torch/`` next to the
package (``build/`` is listed in ``.gitignore``) and loaded with
``ctypes``; ``build_all()`` compiles both at once, one ``nvcc`` per
source, started together.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "zipkin_tpu_torch"
SOURCES = ("flat_histogram", "arena_claim_scatter")

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_ARGTYPES = {
    "zt_flat_histogram": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                          _P],
    "zt_arena_claim_scatter": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        _P,
    ],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names=SOURCES) -> float:
    """Compile every stale kernel library, one nvcc per source, all
    started together. Returns the wall seconds spent. Raises with the
    compiler's output if a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, device, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1: flat histogram
# ---------------------------------------------------------------------------


def histogram_update_plain(counts: torch.Tensor, idx: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``counts.view(-1)[idx] += weights`` for 0 <= idx < m,
    in place (the function of pallas_kernels.scatter_histogram_xla)."""
    flat = counts.view(-1)
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < flat.shape[0])
    flat.index_add_(0, idx[ok], weights.to(flat.dtype)[ok])
    return counts


def histogram_update(counts: torch.Tensor, idx: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """counts (int32, any shape, contiguous) += the flat scatter of
    ``weights`` at ``idx``; rows with idx < 0 or idx >= counts.numel()
    are dropped. Updates ``counts`` in place (where the TPU kernel
    returns a delta) and returns it."""
    if counts.device.type == "cpu":
        return histogram_update_plain(counts, idx, weights)
    dev = counts.device
    n = idx.shape[0]
    _check(counts, "counts", torch.int32, dev)
    _check(idx, "idx", torch.int32, dev, (n,))
    _check(weights, "weights", torch.int32, dev, (n,))
    rc = _lib("flat_histogram").zt_flat_histogram(
        counts.data_ptr(), idx.data_ptr(), weights.data_ptr(), n,
        counts.numel(), _stream())
    _raise_on(rc, "flat_histogram")
    LAUNCHES["flat_histogram"] += 1
    return counts


def flat_histogram(idx: torch.Tensor, weights: torch.Tensor,
                   m: int) -> torch.Tensor:
    """The TPU kernel's own contract: the [m] int32 histogram delta."""
    out = torch.zeros(m, dtype=torch.int32, device=idx.device)
    return histogram_update(out, idx, weights)


# ---------------------------------------------------------------------------
# K2: fused FIFO claim + arena entry write
# ---------------------------------------------------------------------------

# Scratch budget of the [tiles, buckets] int32 count matrix (256 MiB).
ARENA_SCRATCH_CELLS = 1 << 26
ARENA_ROWS = 256


def fifo_ranks(bucket: torch.Tensor, valid: torch.Tensor,
               n_buckets: int) -> torch.Tensor:
    """Arrival-order rank of each row within its bucket (int32); ~valid
    rows rank among themselves, as in the reference's sentinel key. One
    stable sort by bucket plus a running segment-start fill."""
    n = bucket.shape[0]
    dev = bucket.device
    key = torch.where(valid, bucket.to(torch.int64),
                      torch.full((n,), n_buckets, dtype=torch.int64,
                                 device=dev))
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    idxs = torch.arange(n, dtype=torch.int64, device=dev)
    start = torch.cummax(torch.where(first, idxs, torch.full_like(idxs, -1)),
                         dim=0).values
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[order] = (idxs - start).to(torch.int32)
    return rank


def arena_claim_scatter_plain(entries, bucket, base, slot0, depth, vals,
                              valid, n_buckets: int) -> torch.Tensor:
    """Plain twin: the reference's XLA formulation — FIFO ranks, keep
    the newest ``depth`` rows per bucket, unique row scatter of the
    survivors (in place)."""
    rank = fifo_ranks(bucket, valid, n_buckets)
    b = bucket.to(torch.int64).clamp(0, n_buckets - 1)
    cnt = torch.zeros(n_buckets + 1, dtype=torch.int32,
                      device=bucket.device)
    cnt.index_add_(0, torch.where(valid, b, torch.full_like(b, n_buckets)),
                   torch.ones_like(rank))
    d = depth.to(torch.int32)
    keep = valid & (rank >= cnt[b] - d)
    slot = slot0.to(torch.int64) + ((base.to(torch.int32) + rank) % d).to(
        torch.int64)
    entries[slot[keep]] = vals[keep]
    return entries


def arena_claim_scatter(entries: torch.Tensor, bucket: torch.Tensor,
                        base: torch.Tensor, slot0: torch.Tensor,
                        depth: torch.Tensor, vals: torch.Tensor,
                        valid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Fused FIFO claim + entry-row scatter over the unified [slots, 3]
    int64 index arena, same signature as the TPU kernel: ``bucket``
    clipped to [0, n_buckets); ``base`` each row's bucket cursor low
    word; ``slot0`` the bucket's first arena row; ``depth`` per-row
    powers of two; ``vals`` [n, 3] int64. Returns the arena (updated in
    place); the result is bitwise the arrival-order overwrite."""
    if entries.device.type == "cpu":
        return arena_claim_scatter_plain(entries, bucket, base, slot0,
                                         depth, vals, valid, n_buckets)
    dev = entries.device
    n = bucket.shape[0]
    _check(entries, "entries", torch.int64, dev)
    if entries.dim() != 2 or entries.shape[1] != 3:
        raise ValueError("entries must be [slots, 3]")
    _check(bucket, "bucket", torch.int32, dev, (n,))
    _check(base, "base", torch.int32, dev, (n,))
    _check(slot0, "slot0", torch.int64, dev, (n,))
    _check(depth, "depth", torch.int32, dev, (n,))
    _check(vals, "vals", torch.int64, dev, (n, 3))
    _check(valid, "valid", torch.bool, dev, (n,))
    if n == 0:
        return entries
    if not 0 < n_buckets < (1 << 31):
        raise ValueError(f"n_buckets out of range: {n_buckets}")
    n_tiles = max(1, min(-(-n // ARENA_ROWS),
                         ARENA_SCRATCH_CELLS // n_buckets))
    tile = -(-n // n_tiles)
    tile = -(-tile // ARENA_ROWS) * ARENA_ROWS
    n_tiles = -(-n // tile)
    tc = torch.empty(n_tiles * n_buckets, dtype=torch.int32, device=dev)
    cnt = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    rc = _lib("arena_claim_scatter").zt_arena_claim_scatter(
        entries.data_ptr(), bucket.data_ptr(), base.data_ptr(),
        slot0.data_ptr(), depth.data_ptr(), vals.data_ptr(),
        valid.data_ptr(), tc.data_ptr(), cnt.data_ptr(), n, n_buckets,
        n_tiles, tile, entries.shape[0], _stream())
    _raise_on(rc, "arena_claim_scatter")
    LAUNCHES["arena_claim_scatter"] += 1
    return entries
