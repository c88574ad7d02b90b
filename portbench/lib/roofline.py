"""The yardstick's peaks and each hand-written kernel's least bytes.

Every function counts what the kernel's inputs need: each input byte
read once and each output byte written once (cells a histogram touches
read and written once each). A share of the roofline is the least time
(bytes over the peak bandwidth) over the kernel's device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "bf16_flops": 989e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def bytes_per_s(card: str) -> float:
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])["bytes_per_s"]


def k1_bytes(rows: int, touched: int) -> int:
    """K1 (``flat_histogram``, one launch over every site): a 4-byte index
    a row (no weights) and each touched count cell read and written."""
    return rows * 4 + touched * 8


def k2_claim_bytes(rows: int, buckets: int) -> int:
    """K2's claim half: each row's bucket (4 B) and valid flag (1 B) in,
    its rank (4 B) out, and the per-bucket counts (4 B) out."""
    return rows * (4 + 1 + 4) + buckets * 4


def k2_write_bytes(rows: int, valid: int, buckets: int, kept: int) -> int:
    """K2's write half: every row's valid flag (1 B) in; each valid row's
    bucket, rank and depth (12 B) in; the count of each bucket a valid
    row names (4 B) in; each kept row's base, first slot and 24-byte
    entry (36 B) in and its entry (24 B) out."""
    return rows + valid * 12 + buckets * 4 + kept * 60


def k3_bytes(live_pages: int, pages: int, page_rows: int,
             col_bytes: int, n_cols: int) -> int:
    """K3 (``paged_page_gather``): the live pages' rows of every column
    read once, every requested page's rows written as int64."""
    return live_pages * page_rows * col_bytes + pages * page_rows * n_cols * 8


def cms_update_bytes(keys: int, depth: int, touched: int,
                     index_bytes: int = 8) -> int:
    """``cms_update``: each key's ``depth`` bucket indices read, each
    touched cell read and written."""
    return keys * depth * index_bytes + touched * 8


def share(bytes_moved: int, seconds: float, card: str) -> float:
    """Percent of the bandwidth roofline: least time over device time."""
    return 100.0 * bytes_moved / bytes_per_s(card) / seconds
