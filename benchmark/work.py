"""The yardstick's arithmetic: the card's peaks and each op's work.

Every counter here counts the work an op needs for the cell's shapes (the
operations, and each compulsory byte read or written once), not what one
kernel happens to read: a roofline share then reads the same work whatever
implements the op. The maps in ``benchmark/kernels/<op>.json`` name the
profiler kernels that implement each op and the counter here that prices it.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, NamedTuple

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


class Peaks(NamedTuple):
    bf16_flops: float      # dense bf16 tensor-core operations per second
    hbm_bytes_s: float     # device memory bytes per second


#: published peaks by the name ``torch.cuda.get_device_name()`` gives; a card
#: that is not listed has no peak here, and the benchmark refuses to guess one
PEAKS: Dict[str, Peaks] = {
    # NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": Peaks(989e12, 3.35e12),
}


def peaks_for(device_name: str) -> Peaks:
    try:
        return PEAKS[device_name]
    except KeyError:
        raise KeyError(f"no published peaks for {device_name!r}; add the card to "
                       "benchmark/work.py::PEAKS") from None


def bound_s(flops: float, byts: float, peaks: Peaks) -> float:
    """Least time of the work on the card: operations at the bf16 peak or
    bytes at the memory peak, whichever is longer."""
    return max(flops / peaks.bf16_flops, byts / peaks.hbm_bytes_s)


# ---------------------------------------------------------------------------
# serving: the masked score op (B2) and the whole dispatch
# ---------------------------------------------------------------------------


def masked_score_work(queries: int, items: int, dim: int, itemsize: int = 2):
    """(flops, bytes) of scoring ``queries`` rows against ``items`` catalog
    rows with the train-seen mask and the maxima of every 128 columns:
    2·Q·N·d operations; the query and catalog rows and one mask bit per pair
    read once, one chunk maximum per 128 columns written. The (Q, N) score
    matrix is not compulsory: a design may keep it on chip."""
    chunks = -(-items // 128)
    byts = ((queries + items) * dim * itemsize + queries * items / 8
            + queries * chunks * itemsize)
    return 2.0 * queries * items * dim, float(byts)


def dispatch_model_flops(queries: int, items: int, dim: int) -> float:
    """Model operations of one dispatch: every user scored against every item."""
    return 2.0 * queries * items * dim


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def row_sums_bytes(entries: int, rows: int, dim: int, sums: int = 1,
                   itemsize: int = 4) -> float:
    """Compulsory bytes of ``sums`` row sums of ``entries`` real entries into
    a (rows, d) table: each entry's row and index read once, the whole table
    written once."""
    return float(sums * (entries * (dim * itemsize + 4) + rows * dim * itemsize))


def remainder_hop_bytes(edges: int, rows: int, num_src: int, num_nodes: int,
                        dim: int, itemsize: int = 4) -> float:
    """Compulsory bytes of one hop over the sparse remainder: each real edge's
    source id and weight (8 bytes), each row's node id, the source table read
    once and the result written once."""
    return float(edges * 8 + rows * 4 + (num_src + num_nodes) * dim * itemsize)


def train_step_model_flops(edges: int, real_triplets: int, negatives: int, dim: int,
                           layers: int) -> float:
    """Model operations of one step: 3 × the forward pass, which is ``layers``
    hops of 2·nnz·d over the real edges plus 2·(1 + K)·d scores per real
    triplet. Padding, dense block zeros and the optimizer are not counted."""
    forward = layers * 2.0 * edges * dim + 2.0 * real_triplets * (1 + negatives) * dim
    return 3.0 * forward


# ---------------------------------------------------------------------------
# kernel maps
# ---------------------------------------------------------------------------


def kernel_map(op: str) -> dict:
    """``benchmark/kernels/<op>.json``: {"kernels": [names], "counter": name}."""
    return json.loads((KERNELS_DIR / f"{op}.json").read_text())


def matches(kernel_name: str, names: List[str]) -> bool:
    """Whether a profiler kernel name (a demangled signature such as
    ``void (anonymous namespace)::foo_kernel<float, 8>(...)``) names one of
    ``names`` as its function: the identifier right before its template or
    argument list."""
    return any(re.search(r"(?:^|[\s:])" + re.escape(n) + r"\s*[<(]", kernel_name)
               for n in names)
