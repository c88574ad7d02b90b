"""The store's hand-written CUDA kernels, with their plain twins.

- ``histogram_update_many`` -> ``csrc/flat_histogram.cu``: replaces the
  TPU kernel ``zipkin_tpu/ops/pallas_kernels.py:flat_histogram``; one
  launch adds up to eight flat histograms (the ingest step's seven
  sites); ``histogram_update`` is its one-site call.
- ``cms_update`` -> ``csrc/cms_update.cu``: replaces the TPU function
  ``pallas_kernels.cms_update`` (a count-min table's update, one
  flat_histogram over depth x width there); one launch reads the
  [depth, n] buckets in place, with no flat index built first. The
  standalone sketch API takes it; the ingest step fuses its own
  count-min site into ``histogram_update_many``.
- ``arena_claim`` + ``arena_write`` -> ``csrc/arena_claim_scatter.cu``:
  together they replace ``zipkin_tpu/ops/pallas_kernels.py:
  arena_claim_scatter`` (``arena_claim_scatter`` here calls the two). The
  claim gives every row's FIFO rank and every bucket's count, which the
  ingest step needs before the write anyway; the write stores the
  survivors.
- ``paged_page_gather`` -> ``csrc/paged_page_gather.cu``: replaces
  ``zipkin_tpu/ops/pallas_kernels.py:paged_page_gather``. It reads the
  span columns in place, so the [2 x 14, capacity] int32 plane matrix
  the TPU kernel gathers from is never built; none of the TPU kernel's
  gates (``page_rows % 128``, the VMEM ceiling) apply: the store takes
  it whenever ``use_pallas`` is set, for any power-of-two page size.

Each wrapper takes its plain PyTorch twin ONLY for tensors on the CPU
(the tests run there). For CUDA tensors it launches its kernel or
raises; no path falls back. ``LAUNCHES`` counts kernel launches per
wrapper (the twins do not count), so a run can show the store went
through the kernels. Under a step census (``store/census.py``) each
wrapper the step calls also counts its call there, once, and runs as
it always does (``cms_update`` is off the step and outside the
census).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
plain-C shared libraries under ``build/zipkin_tpu_torch/`` next to the
package (``build/`` is listed in ``.gitignore``) and loaded with
``ctypes``; ``build_all()`` compiles every source at once, one ``nvcc``
per source, started together.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "zipkin_tpu_torch"
SOURCES = ("flat_histogram", "cms_update", "arena_claim_scatter",
           "paged_page_gather")
INGEST_SOURCES = ("flat_histogram", "arena_claim_scatter")
QUERY_SOURCES = ("paged_page_gather",)
KERNELS = ("flat_histogram", "cms_update", "arena_claim", "arena_write",
           "paged_page_gather")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_ARGTYPES = {
    "zt_flat_histogram_multi": [ctypes.POINTER(ctypes.c_longlong),
                                ctypes.c_int, _P],
    "zt_cms_update": [_P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, _P],
    "zt_arena_claim": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                       _P],
    "zt_arena_write": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       _P],
    "zt_arena_claim_scratch": [ctypes.c_longlong, ctypes.c_int],
    "zt_paged_page_gather": [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        _P,
    ],
}
_RESTYPES = {"zt_arena_claim_scratch": ctypes.c_longlong}


def compile_count(names) -> int:
    """Kernel libraries of ``names`` this process has loaded (built, or
    found fresh in ``BUILD_DIR``): each source loads once, at its first
    use, so the count stays flat after warm-up. The store reports it as
    the reference's jit-compile counters (``TorchSpanStore.counters``)."""
    return sum(1 for n in names if n in _LIBS)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _CensusHook(threading.local):
    """While ``store/census.py`` counts a step on this thread, ``hook``
    takes a kernel's name and returns the context its call runs in."""

    hook = None


CENSUS = _CensusHook()


def _counted(name: str):
    """Wrapper decorator: while a census runs on this thread the call
    counts once under ``name`` and runs inside the census's context,
    which does not count the ops the wrapper dispatches (its twin's on
    the CPU; a kernel's ctypes launch reaches no dispatcher), so a
    step's census is the same on the CPU and on the card."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            hook = CENSUS.hook
            if hook is None:
                return fn(*a, **kw)
            with hook(name):
                return fn(*a, **kw)
        return call
    return deco


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


def nvcc_command(src, out, nvcc=None) -> list:
    """The nvcc command that builds ``src`` into the shared library
    ``out`` (sm_90a, plain C interface, register report)."""
    return [nvcc or _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas=-v", "-o", str(out), str(src)]


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
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp, nvcc),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
                getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
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


def _stream(dev: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``dev`` (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without
    building a Stream object on every call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


# ---------------------------------------------------------------------------
# K1: flat histogram, up to HIST_MAX_SITES sites a launch
# ---------------------------------------------------------------------------

HIST_MAX_SITES = 8
_HIST_ROW = 5  # counts, m, idx, n, weights (0: weight 1)
_HIST_TABLE = ctypes.c_longlong * (HIST_MAX_SITES * _HIST_ROW)


def histogram_update_plain(counts: torch.Tensor, idx: torch.Tensor,
                           weights=None) -> torch.Tensor:
    """Plain twin: ``counts.view(-1)[idx] += weights`` (ones where
    ``weights`` is None) for 0 <= idx < m, in place (the function of
    pallas_kernels.scatter_histogram_xla)."""
    flat = counts.view(-1)
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < flat.shape[0])
    w = (torch.ones(idx.shape, dtype=flat.dtype, device=flat.device)
         if weights is None else weights.to(flat.dtype))
    flat.index_add_(0, idx[ok], w[ok])
    return counts


def histogram_update_many_plain(sites) -> None:
    """Plain twin of ``histogram_update_many``: each site in turn."""
    for counts, idx, weights in sites:
        histogram_update_plain(counts, idx, weights)


def _check_sites(sites, dev) -> None:
    """Raise unless every site is int32, contiguous, on ``dev``, with a
    1-D idx and weights (where given) of its length. The common case
    costs one boolean chain a site; the message is built on failure."""
    if len(sites) > HIST_MAX_SITES:
        raise ValueError(f"flat_histogram: {len(sites)} sites, at most "
                         f"{HIST_MAX_SITES}")
    i32 = torch.int32
    for k, (counts, idx, weights) in enumerate(sites):
        if (counts.dtype != i32 or idx.dtype != i32 or counts.device != dev
                or idx.device != dev or not counts.is_contiguous()
                or not idx.is_contiguous() or idx.dim() != 1
                or (weights is not None and (
                    weights.dtype != i32 or weights.device != dev
                    or not weights.is_contiguous()
                    or weights.shape != idx.shape))):
            n = idx.shape[0] if idx.dim() else 0
            _check(counts, f"sites[{k}].counts", i32, dev)
            _check(idx, f"sites[{k}].idx", i32, dev, (n,))
            _check(weights, f"sites[{k}].weights", i32, dev, (n,))


def hist_table(sites):
    """The foreign-call table of checked sites (``_HIST_ROW`` values a
    site) and their total rows."""
    table = _HIST_TABLE()
    rows = 0
    for k, (counts, idx, weights) in enumerate(sites):
        n = idx.shape[0]
        rows += n
        table[k * _HIST_ROW:(k + 1) * _HIST_ROW] = (
            counts.data_ptr(), counts.numel(), idx.data_ptr(), n,
            0 if weights is None else weights.data_ptr())
    return table, rows


@_counted("flat_histogram")
def histogram_update_many(sites) -> None:
    """Up to ``HIST_MAX_SITES`` flat histograms in ONE kernel launch:
    for each ``(counts, idx, weights)`` site, ``counts`` (int32, any
    shape, contiguous) += the flat scatter of ``weights`` (int32 [n], or
    None for ones) at ``idx`` (int32 [n]); rows with idx < 0 or idx >=
    counts.numel() are dropped. In place. Every tensor lies on one
    device; CPU tensors run the twin."""
    sites = tuple(sites)
    if not sites:
        return
    dev = sites[0][0].device
    _check_sites(sites, dev)
    if dev.type == "cpu":
        return histogram_update_many_plain(sites)
    table, rows = hist_table(sites)
    if rows == 0:
        return
    rc = _lib("flat_histogram").zt_flat_histogram_multi(
        table, len(sites), _stream(dev))
    _raise_on(rc, "flat_histogram")
    LAUNCHES["flat_histogram"] += 1


def histogram_update(counts: torch.Tensor, idx: torch.Tensor,
                     weights=None) -> torch.Tensor:
    """One site of ``histogram_update_many`` (one launch on the card):
    counts += the flat scatter of ``weights`` (None: ones) at ``idx``,
    in place; returns ``counts``."""
    histogram_update_many(((counts, idx, weights),))
    return counts


def flat_histogram(idx: torch.Tensor, weights: torch.Tensor,
                   m: int) -> torch.Tensor:
    """The TPU kernel's own contract: the [m] int32 histogram delta."""
    out = torch.zeros(m, dtype=torch.int32, device=idx.device)
    return histogram_update(out, idx, weights)


def cms_flat_index(idx_rows: torch.Tensor, width: int) -> torch.Tensor:
    """The plain twin's flat int32 index into a [D, width] table of
    per-row buckets ``idx_rows`` [D, N] (row r's bucket plus r x width;
    -1 where a bucket is negative), as ``pallas_kernels.cms_update``
    flattens (in int32, as it does; int64 buckets cut to int32 first).
    No fill kernel: a profile finds its calls by the flush's fill."""
    idx = idx_rows.to(torch.int32)
    rows = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    flat = idx + (rows * width)[:, None]
    return flat.masked_fill_(idx < 0, -1).reshape(-1)


def cms_update_plain(counts: torch.Tensor, idx_rows: torch.Tensor,
                     weights=None) -> torch.Tensor:
    """Plain twin of ``cms_update``: ``histogram_update_plain`` over
    ``cms_flat_index`` with the weights repeated for every row."""
    if weights is not None:
        weights = weights.repeat(idx_rows.shape[0])
    return histogram_update_plain(
        counts, cms_flat_index(idx_rows, counts.shape[1]), weights)


_CMS_BUCKETS = (torch.int32, torch.int64)


def _check_cms(counts, idx_rows, weights) -> None:
    """Raise unless ``counts`` is int32 [D, W] (D x W < 2^31),
    ``idx_rows`` int32 or int64 [D, N] and ``weights`` None or int32
    [N], all contiguous on one device. The common case costs one
    boolean chain over each shape read once; the message is built on
    failure."""
    cs, rs = counts.shape, idx_rows.shape
    if (counts.dtype == torch.int32 and idx_rows.dtype in _CMS_BUCKETS
            and len(cs) == 2 and len(rs) == 2 and cs[0] == rs[0]
            and cs[0] * cs[1] < 1 << 31 and counts.is_contiguous()
            and idx_rows.is_contiguous()
            and idx_rows.device == counts.device
            and (weights is None or (
                weights.dtype == torch.int32
                and weights.shape == rs[1:] and weights.is_contiguous()
                and weights.device == counts.device))):
        return
    dev = counts.device
    if idx_rows.dtype not in _CMS_BUCKETS:
        raise TypeError(f"idx_rows: expected int32 or int64, got "
                        f"{idx_rows.dtype}")
    if len(cs) != 2 or len(rs) != 2 or cs[0] != rs[0]:
        raise ValueError(f"cms_update: counts [D, W] and idx_rows [D, N] "
                         f"expected, got {tuple(cs)} and {tuple(rs)}")
    if cs[0] * cs[1] >= 1 << 31:
        raise ValueError("cms_update: D x W must be below 2^31")
    _check(counts, "counts", torch.int32, dev)
    _check(idx_rows, "idx_rows", idx_rows.dtype, dev)
    if weights is not None:
        _check(weights, "weights", torch.int32, dev, rs[1:])


def cms_update(counts: torch.Tensor, idx_rows: torch.Tensor,
               weights=None) -> torch.Tensor:
    """Count-min update, the function of ``pallas_kernels.cms_update``:
    int32 ``counts`` [D, W] += the per-row scatter of ``idx_rows`` [D, N]
    (a key's bucket in each row, int32 or int64; int64 cut to int32 as
    ``.to(torch.int32)`` cuts it) with ``weights`` int32 [N] (None:
    ones). Narrower than ``pallas_kernels.cms_update``, which broadcasts
    and casts any weights: weights of another dtype or shape raise
    (``cms.update`` routes them to ``index_add_``). Row r's bucket b lands in flat cell b + r x W (int32, so a
    bucket >= W lands in the next row); negative buckets and cells past
    D x W are dropped. In place; returns ``counts``. One kernel launch
    on the card (none when D or N is 0), the plain twin
    (``cms_update_plain``) on the CPU."""
    _check_cms(counts, idx_rows, weights)
    if not counts.is_cuda:
        return cms_update_plain(counts, idx_rows, weights)
    d, n = idx_rows.shape
    if d == 0 or n == 0:
        return counts
    index = counts.get_device()
    rc = _lib("cms_update").zt_cms_update(
        counts.data_ptr(), idx_rows.data_ptr(), idx_rows.element_size(),
        None if weights is None else weights.data_ptr(), d, counts.shape[1],
        n, torch._C._cuda_getCurrentRawStream(index))
    _raise_on(rc, "cms_update")
    LAUNCHES["cms_update"] += 1
    return counts


# ---------------------------------------------------------------------------
# K2: FIFO claim (arena_claim) + arena entry write (arena_write)
# ---------------------------------------------------------------------------


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


def arena_claim_plain(bucket: torch.Tensor, valid: torch.Tensor,
                      n_buckets: int):
    """Plain twin of the claim: ``(fifo_ranks, cnt)``, ``cnt`` the int32
    [n_buckets] count of valid rows per bucket. A valid row whose bucket
    lies outside [0, n_buckets) is taken as invalid (the step's seg()
    clips every bucket, so it never makes one)."""
    b = bucket.to(torch.int64)
    ok = valid & (b >= 0) & (b < n_buckets)
    rank = fifo_ranks(bucket, ok, n_buckets)
    cnt = torch.zeros(n_buckets + 1, dtype=torch.int32, device=bucket.device)
    cnt.index_add_(0, torch.where(ok, b, torch.full_like(b, n_buckets)),
                   torch.ones_like(rank))
    return rank, cnt[:n_buckets]


@_counted("arena_claim")
def arena_claim(bucket: torch.Tensor, valid: torch.Tensor, n_buckets: int):
    """Each row's FIFO rank within its bucket and each bucket's count of
    valid rows, bitwise ``arena_claim_plain``: ``(rank int32 [n], cnt
    int32 [n_buckets])``. ``bucket`` int32, ``valid`` bool."""
    if bucket.device.type == "cpu":
        return arena_claim_plain(bucket, valid, n_buckets)
    dev = bucket.device
    n = bucket.shape[0]
    _check(bucket, "bucket", torch.int32, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    if not 0 < n_buckets < (1 << 31) - 1:
        raise ValueError(f"n_buckets out of range: {n_buckets}")
    if n >= 1 << 31:
        raise ValueError(f"arena_claim: {n} rows, at most 2^31 - 1")
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return rank, torch.zeros(n_buckets, dtype=torch.int32, device=dev)
    cnt = torch.empty(n_buckets + 1, dtype=torch.int32, device=dev)
    lib = _lib("arena_claim_scatter")
    scratch = torch.empty(lib.zt_arena_claim_scratch(n, n_buckets),
                          dtype=torch.int32, device=dev)
    rc = lib.zt_arena_claim(bucket.data_ptr(), valid.data_ptr(), n,
                            n_buckets, rank.data_ptr(), cnt.data_ptr(),
                            scratch.data_ptr(), _stream(dev))
    _raise_on(rc, "arena_claim")
    LAUNCHES["arena_claim"] += 1
    return rank, cnt[:n_buckets]


def arena_write_plain(entries, rank, cnt, bucket, base, slot0, depth, vals,
                      valid) -> torch.Tensor:
    """Plain twin of the write: the masked unique scatter of the
    survivors (rank >= cnt[bucket] - depth) at slot0 + ((base + rank) &
    (depth - 1)), in place; rows out of range of the buckets or of the
    arena are dropped."""
    n_b = cnt.shape[0]
    b = bucket.to(torch.int64)
    ok = valid & (b >= 0) & (b < n_b)
    b = b.clamp(0, n_b - 1)
    d = depth.to(torch.int32)
    slot = slot0.to(torch.int64) + ((base.to(torch.int32) + rank) % d).to(
        torch.int64)
    keep = (ok & (rank >= cnt[b] - d) & (slot >= 0)
            & (slot < entries.shape[0]))
    entries[slot[keep]] = vals[keep]
    return entries


@_counted("arena_write")
def arena_write(entries: torch.Tensor, rank: torch.Tensor, cnt: torch.Tensor,
                bucket: torch.Tensor, base: torch.Tensor, slot0: torch.Tensor,
                depth: torch.Tensor, vals: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Write the survivors' (gid, verify, ts) triples into the [slots, 3]
    int64 arena in place, from the claim's ``rank`` and ``cnt``; bitwise
    ``arena_write_plain``. Returns the arena."""
    if entries.device.type == "cpu":
        return arena_write_plain(entries, rank, cnt, bucket, base, slot0,
                                 depth, vals, valid)
    dev = entries.device
    n = bucket.shape[0]
    n_b = cnt.shape[0]
    _check(entries, "entries", torch.int64, dev)
    if entries.dim() != 2 or entries.shape[1] != 3:
        raise ValueError("entries must be [slots, 3]")
    _check(rank, "rank", torch.int32, dev, (n,))
    _check(cnt, "cnt", torch.int32, dev, (n_b,))
    _check(bucket, "bucket", torch.int32, dev, (n,))
    _check(base, "base", torch.int32, dev, (n,))
    _check(slot0, "slot0", torch.int64, dev, (n,))
    _check(depth, "depth", torch.int32, dev, (n,))
    _check(vals, "vals", torch.int64, dev, (n, 3))
    _check(valid, "valid", torch.bool, dev, (n,))
    if n == 0:
        return entries
    rc = _lib("arena_claim_scatter").zt_arena_write(
        entries.data_ptr(), rank.data_ptr(), cnt.data_ptr(),
        bucket.data_ptr(), base.data_ptr(), slot0.data_ptr(),
        depth.data_ptr(), vals.data_ptr(), valid.data_ptr(), n, n_b,
        entries.shape[0], _stream(dev))
    _raise_on(rc, "arena_write")
    LAUNCHES["arena_write"] += 1
    return entries


def arena_claim_scatter_plain(entries, bucket, base, slot0, depth, vals,
                              valid, n_buckets: int) -> torch.Tensor:
    """Plain twin of the whole function: the reference's XLA formulation
    (FIFO ranks, keep the newest ``depth`` rows per bucket, unique row
    scatter of the survivors), in place."""
    rank, cnt = arena_claim_plain(bucket, valid, n_buckets)
    return arena_write_plain(entries, rank, cnt, bucket, base, slot0, depth,
                             vals, valid)


def arena_claim_scatter(entries: torch.Tensor, bucket: torch.Tensor,
                        base: torch.Tensor, slot0: torch.Tensor,
                        depth: torch.Tensor, vals: torch.Tensor,
                        valid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """FIFO claim + entry-row scatter over the unified [slots, 3] int64
    index arena, same signature as the TPU kernel: ``bucket`` in [0,
    n_buckets); ``base`` each row's bucket cursor low word; ``slot0`` the
    bucket's first arena row; ``depth`` per-row powers of two; ``vals``
    [n, 3] int64. The claim, then the write; returns the arena (updated
    in place), bitwise the arrival-order overwrite."""
    rank, cnt = arena_claim(bucket, valid, n_buckets)
    return arena_write(entries, rank, cnt, bucket, base, slot0, depth, vals,
                       valid)


# ---------------------------------------------------------------------------
# K3: paged trace-assembly block gather
# ---------------------------------------------------------------------------

PAGE_GATHER_MAX_COLS = 16
_GATHER_TABLES: Dict[tuple, tuple] = {}
_GATHER_TABLES_MAX = 8


def paged_page_gather_plain(cols, pages: torch.Tensor,
                            page_rows: int) -> torch.Tensor:
    """Plain twin: ``[C, K * page_rows]`` int64, block ``i`` the rows of
    page ``pages[i]`` of every column (int32 columns sign-extended), all
    zeros where the page is a hole (outside ``[0, n_pages)``)."""
    n_pages = cols[0].shape[0] // page_rows
    p = pages.to(torch.int64)
    hole = (p < 0) | (p >= n_pages)
    offs = torch.arange(page_rows, dtype=torch.int64, device=p.device)
    slot = (torch.clamp(p, 0, n_pages - 1)[:, None] * page_rows
            + offs[None, :]).reshape(-1)
    out = torch.stack([col[slot].to(torch.int64) for col in cols])
    keep = (~hole).repeat_interleave(page_rows)
    return torch.where(keep[None], out, torch.zeros_like(out))


def _gather_table(cols, page_rows: int, dev):
    """The validated foreign-call table of a column set: (ctypes column
    pointers, ctypes element sizes, capacity, the first column's
    data_ptr, weak references to the columns). Cached by ``page_rows``
    and the identity of each column tensor: a hit costs one tuple of
    ids, one lookup and a data_ptr spot-check of the first column, and
    runs no per-column check. An entry leaves the cache as soon as any
    of its columns is freed (a weak reference's callback), so the id of
    a live column in a key never names another tensor; a column that
    was replaced by another tensor (a step or a restore rebinds leaves)
    is another id and misses."""
    key = (page_rows, *map(id, cols))
    hit = _GATHER_TABLES.get(key)
    if hit is not None and hit[3] == cols[0].data_ptr():
        return hit
    cap = cols[0].shape[0]
    if len(cols) > PAGE_GATHER_MAX_COLS:
        raise ValueError(f"paged_page_gather: at most "
                         f"{PAGE_GATHER_MAX_COLS} columns")
    if page_rows < 8 or page_rows & (page_rows - 1):
        raise ValueError("page_rows must be a power of two >= 8")
    if cap % page_rows:
        raise ValueError("column length must be a multiple of page_rows")
    for i, col in enumerate(cols):
        if col.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"cols[{i}]: expected int64 or int32, got "
                            f"{col.dtype}")
        _check(col, f"cols[{i}]", col.dtype, dev, (cap,))

    def drop(_ref):
        _GATHER_TABLES.pop(key, None)

    table = ((ctypes.c_void_p * len(cols))(*(c.data_ptr() for c in cols)),
             (ctypes.c_int * len(cols))(*(c.element_size() for c in cols)),
             cap, cols[0].data_ptr(),
             tuple(weakref.ref(c, drop) for c in cols))
    if len(_GATHER_TABLES) >= _GATHER_TABLES_MAX:
        _GATHER_TABLES.clear()
    _GATHER_TABLES[key] = table
    return table


@_counted("paged_page_gather")
def paged_page_gather(cols, pages: torch.Tensor,
                      page_rows: int) -> torch.Tensor:
    """Gather ``K = len(pages)`` pages of ``page_rows`` rows out of the
    span columns ``cols`` (each 1-D, contiguous, int64 or int32, one
    length ``capacity``) into a new ``[len(cols), K * page_rows]`` int64
    matrix: exactly what the TPU kernel's plane output gives once its
    lo/hi planes are recombined to int64. Pages < 0 (or past the last
    page) are holes and give zero blocks."""
    if not cols:
        raise ValueError("paged_page_gather: no columns")
    dev = cols[0].device
    if dev.type == "cpu":
        return paged_page_gather_plain(cols, pages, page_rows)
    ptrs, sizes, cap, _, _ = _gather_table(cols, page_rows, dev)
    if (pages.dtype != torch.int32 or pages.device != dev
            or pages.dim() != 1 or not pages.is_contiguous()):
        _check(pages, "pages", torch.int32, dev)
        raise ValueError(f"pages: expected 1-D, got {pages.dim()}-D")
    k = pages.shape[0]
    out = torch.empty((len(cols), k * page_rows), dtype=torch.int64,
                      device=dev)
    if k == 0:
        return out
    rc = _lib("paged_page_gather").zt_paged_page_gather(
        ptrs, sizes, len(cols), pages.data_ptr(), out.data_ptr(), k,
        page_rows, cap // page_rows, _stream(dev))
    _raise_on(rc, "paged_page_gather")
    LAUNCHES["paged_page_gather"] += 1
    return out
