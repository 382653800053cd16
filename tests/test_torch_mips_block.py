"""The per-block top-k kernel's algorithm (``csrc/mips_block.cu``, B3), mirrored
in PyTorch on the CPU and held against the kernel's plain version
(``cuda_mips.mips_block_topk_plain``) and against the JAX package's
``mips_topk_pallas`` run in interpret mode.

The mirror repeats the kernel's arithmetic and selection step by step: the
TF32 split by bit operations (round to nearest, ties away from zero: add
``0x1000`` to the bits and clear the low 13), three products ``lo·hi + hi·lo
+ hi·hi`` summed in f32 with K zero-padded to 8, the block walked in tiles,
each query's scores that beat its threshold strictly appended to a bounded
candidate buffer, the buffer compacted by (value desc, column asc) under the
kernel's policy, and the dead-rank rewrite.

Tolerances: scores within 1e-5 of the plain version's exact f32 scores (the
dropped lo·lo term and the TF32 rounding of lo leave about 2^-22 of each
product); an index may differ only where the plain scores of neighbouring
ranks lie within 2e-6 (the two sum orders can swap such a pair); planted
exact ties (copies of one catalog row) come in ascending column order and
equal the plain version's.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from movie_recommender_system_with_gnns_tpu.ops.pallas_mips import mips_topk_pallas
from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_mips
from movie_recommender_system_with_gnns_tpu_torch.ops.topk import NEG_INF, merge_topk

TN, SLACK, SPLIT = 128, 16, 2   # the kernel's kTN, kSlack and kSplit


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi), as ``cvt.rna.tf32.f32``."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def three_products(qh, ql, ch, cl):
    """(Q, C) scores: per k-step of 8, hi·hi into one f32 sum and lo·hi +
    hi·lo into another, the two added at the end, in one fixed order for every
    element (so copies of a row score equally)."""
    big = torch.zeros(qh.shape[0], ch.shape[0], dtype=torch.float32)
    small = torch.zeros_like(big)
    step = lambda a, b, k0: (a[:, None, k0:k0 + 8] * b[None, :, k0:k0 + 8]).sum(-1)
    for k0 in range(0, qh.shape[1], 8):
        small = small + step(ql, ch, k0)
        small = small + step(qh, cl, k0)
        big = big + step(qh, ch, k0)
    return big + small


def _select(v, c, keep):
    """The best ``keep`` of (v, c) by value desc, column asc."""
    order = torch.sort(c, stable=True).indices
    v, c = v[order], c[order]
    order = torch.sort(v, descending=True, stable=True).indices[:keep]
    return v[order], c[order]


def mirror_block_topk(q, c, k, block, mask=None, tn=TN, slack=SLACK, split=SPLIT,
                      early=True):
    """The kernel's algorithm on CPU tensors; same outputs as
    ``mips_block_topk``. A block's tiles are dealt in ``split`` runs (the
    CTAs of a cluster), each streamed into its own buffers; each row's lists
    are then merged by the same selection. Also returns the most entries any
    buffer held."""
    nq, d = q.shape
    n = c.shape[0]
    dpad = -(-d // 8) * 8
    qh, ql = tf32_split(F.pad(q.float(), (0, dpad - d)))
    ch, cl = tf32_split(F.pad(c.float(), (0, dpad - d)))
    kr = -(-k // 8) * 8
    cap = max(tn + kr + slack, split * kr)
    nb = -(-n // block)
    os_ = torch.empty(nb, nq, k)
    oi_ = torch.empty(nb, nq, k, dtype=torch.int32)
    most = 0
    ntiles = -(-block // tn)
    per_part = -(-ntiles // split)
    for j in range(nb):
        lists = []
        for part in range(split):
            thr = [float("-inf")] * nq
            bv = [torch.empty(0)] * nq
            bc = [torch.empty(0, dtype=torch.int64)] * nq
            t_end = min(ntiles, (part + 1) * per_part)
            for t in range(part * per_part, t_end):
                lc = torch.arange(t * tn, min((t + 1) * tn, block))
                gc = j * block + lc
                live = gc < n
                rows = gc.clamp(max=n - 1)
                s = three_products(qh, ql, ch[rows], cl[rows])
                s[:, ~live] = NEG_INF
                if mask is not None:
                    s[(mask[:, rows] != 0) & live[None, :]] = NEG_INF
                last = t == t_end - 1
                for r in range(nq):
                    take = s[r] > thr[r]
                    bv[r] = torch.cat([bv[r], s[r][take]])
                    bc[r] = torch.cat([bc[r], gc[take]])
                    cn = bv[r].numel()
                    most = max(most, cn)
                    assert cn <= cap, "a buffer overflowed"
                    if last or cn > cap - tn or (early and cn >= k and thr[r] == float("-inf")):
                        bv[r], bc[r] = _select(bv[r], bc[r], min(k, cn))
                        thr[r] = bv[r][k - 1].item() if bv[r].numel() >= k else float("-inf")
            lists.append((bv, bc))
        for r in range(nq):
            v = torch.cat([bv[r] for bv, _ in lists])
            i = torch.cat([bc[r] for _, bc in lists])
            most = max(most, v.numel())
            assert v.numel() <= cap, "the merged lists overflowed"
            v, i = _select(v, i, min(k, v.numel()))
            keep = v.numel()
            v = torch.cat([v, torch.full((k - keep,), NEG_INF)])
            i = torch.cat([i, torch.full((k - keep,), j * block)])
            os_[j, r] = v
            oi_[j, r] = torch.where(v == NEG_INF, j * block, i).to(torch.int32)
    return os_, oi_, most


def check_close(s_k, i_k, s_p, i_p):
    """Scores within 1e-5; an index differs only beside a near tie (2e-6)."""
    live = s_p > -1e29
    assert torch.equal(s_k > -1e29, live)
    assert ((s_k - s_p).abs()[live] <= 1e-5).all()
    inf = torch.full_like(s_p[..., :1], float("inf"))
    prev = torch.cat([inf, s_p[..., :-1]], dim=-1)
    nxt = torch.cat([s_p[..., 1:], -inf], dim=-1)
    tie = ((s_p - prev).abs() <= 2e-6) | ((s_p - nxt).abs() <= 2e-6)
    assert ((i_k == i_p) | tie).all()


def _unit(rng, rows, d):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


CASES = {
    # name: (n, d, k, block, tn, slack, split); small tiles and slack put
    # many compactions into a small block; a split of 3 over 4 tiles leaves
    # one run empty
    "ragged": (333, 16, 7, 128, 32, 8, 3),
    "masked": (300, 16, 7, 128, 32, 8, 2),
    "starved": (300, 16, 7, 128, 32, 8, 2),
    "ties": (700, 16, 4, 256, 64, 8, 2),
    "k1": (300, 16, 1, 128, 32, 8, 1),
    "k100": (700, 16, 100, 256, TN, SLACK, SPLIT),
    # past the kernel's shared-memory buffers (k > 128): the same selection
    # over buffers in global scratch, at the kernel's own sizes
    "k_over_fast": (700, 16, 129, 512, TN, SLACK, SPLIT),
    "d30": (333, 30, 7, 128, 32, 8, 2),
    "d100": (333, 100, 7, 128, 32, 8, 2),
}


def _case_inputs(rng, case):
    n, d, k, block, tn, slack, split = CASES[case]
    nq = 9
    q, c = _unit(rng, nq, d), _unit(rng, n, d)
    mask = None
    if case in ("masked", "k_over_fast", "d30", "d100"):
        mask = rng.random((nq, n)) < 0.1
        mask[np.arange(nq), (q @ c.T).argmax(1)] = True
    if case == "starved":
        mask = np.ones((nq, n), bool)
        mask[:, [5, 140, 141]] = False         # three live columns, k = 7
        mask[4] = True                         # and one query with none at all
    if case == "k_over_fast":
        # query 0 scores the catalog in ascending column order, so every
        # column beats its threshold and its buffer fills to the brim
        c = c[np.argsort(c[:, 0])]
        q[0] = 0.0
        q[0, 0] = 1.0
    if case == "ties":
        # copies of row 3: in its own tile (5), the next tile (70), a later
        # tile after the first compaction (200) and the next block (300);
        # query 0 is row 3, so the tie is its best
        for col in (5, 70, 200, 300):
            c[col] = c[3]
        q[0] = c[3]
    return q, c, mask, k, block, dict(tn=tn, slack=slack, split=split)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_plain(rng, case):
    """The mirror against the kernel's plain version, block by block."""
    q, c, mask, k, block, kw = _case_inputs(rng, case)
    m = None if mask is None else torch.from_numpy(mask.astype(np.int8))
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    s_m, i_m, most = mirror_block_topk(qt, ct, k, block, m, **kw)
    s_p, i_p = cuda_mips.mips_block_topk_plain(qt, ct, k, block=block, mask=m)
    assert s_m.shape == s_p.shape and i_m.dtype == i_p.dtype == torch.int32
    check_close(s_m, i_m, s_p, i_p)
    # dead ranks name the block's first column
    first = (torch.arange(s_m.shape[0]) * block)[:, None, None].expand_as(i_m)
    dead = s_m == NEG_INF
    assert torch.equal(i_m[dead], first[dead])
    # exact ties keep ascending columns
    same = (s_m[..., 1:] == s_m[..., :-1]) & (s_m[..., 1:] > -1e29)
    assert (i_m[..., 1:] > i_m[..., :-1])[same].all()
    if case == "ties":
        assert i_m[0, 0, :4].tolist() == [3, 5, 70, 200]
        assert i_m[1, 0, 0].item() == 300
        assert torch.equal(i_m[:, 0, :2], i_p[:, 0, :2])
    if case == "starved":
        assert (s_m[:, 4] == NEG_INF).all()
        assert i_m[:, 4, 0].tolist() == [0, 128, 256]
        assert sorted(i_m[:, 0][s_m[:, 0] > -1e29].tolist()) == [5, 140, 141]
    if case == "k_over_fast":
        assert most > 256     # past what a warp holds in registers: the ranking route


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_pallas_interpret(rng, case):
    """The mirror's candidates, merged, against ``mips_topk_pallas`` in
    interpret mode (the TPU kernel itself)."""
    q, c, mask, k, block, kw = _case_inputs(rng, case)
    m = None if mask is None else torch.from_numpy(mask.astype(np.int8))
    s_m, i_m, _ = mirror_block_topk(torch.from_numpy(q), torch.from_numpy(c), k, block, m,
                                    **kw)
    s_mm, i_mm = merge_topk(s_m, i_m, k)
    s_j, i_j = mips_topk_pallas(jnp.asarray(q), jnp.asarray(c), k=k, block=block,
                                normalize=False,
                                exclude_mask=None if mask is None else jnp.asarray(mask))
    s_j = torch.from_numpy(np.array(s_j))
    i_j = torch.from_numpy(np.array(i_j)).to(i_mm.dtype)
    check_close(s_mm[None], i_mm[None], s_j[None], i_j[None])
    if case == "ties":
        assert i_mm[0].tolist() == [3, 5, 70, 200]


def test_tf32_split_rounds_to_nearest_ties_away():
    """The split's bit rounding: ties go away from zero; hi keeps 10 explicit
    mantissa bits; hi + lo recovers x to about 2^-22 of it."""
    one = 0x3F800000
    x = torch.tensor([one + 0x1000, one + 0x0FFF, one + 0x1001, one + 0x3000],
                     dtype=torch.int32).view(torch.float32)
    hi, lo = tf32_split(torch.cat([x, -x]))
    bits = hi.view(torch.int32) & 0x7FFFFFFF
    assert bits.tolist() == [one + 0x2000, one, one + 0x2000, one + 0x4000] * 2
    y = torch.randn(10_000)
    hi, lo = tf32_split(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


def test_three_products_error_against_f64(rng):
    """Three TF32 products on unit rows at d = 64 stay within 1e-6 of the
    exact dot product (the kernel's score tolerance is 1e-5)."""
    q = torch.from_numpy(_unit(rng, 64, 64))
    c = torch.from_numpy(_unit(rng, 512, 64))
    qh, ql = tf32_split(q)
    ch, cl = tf32_split(c)
    s = three_products(qh, ql, ch, cl)
    exact = q.double() @ c.double().T
    assert (s.double() - exact).abs().max().item() < 1e-6
    one = qh @ ch.T          # a single TF32 product would not do
    assert (one.double() - exact).abs().max().item() > 1e-5


def _probe_variants() -> dict:
    """``VARIANTS`` of ``tools/probe_mips_block.py`` (which imports only torch
    at module level)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_mips_block.py"
    spec = importlib.util.spec_from_file_location("probe_mips_block", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


_PROBE_VARIANTS = _probe_variants()


@pytest.mark.parametrize("variant", sorted(_PROBE_VARIANTS))
def test_probe_variant_patches_kernel_source(variant):
    """Each variant of the B3 probe rewrites lines that the kernel source has
    exactly once, and changes the source: the probe follows the kernel."""
    src = (_build.CSRC / "mips_block.cu").read_text()
    text = src
    for line, repl in _PROBE_VARIANTS[variant]:
        assert src.count(line) == 1, line
        text = text.replace(line, repl)
    assert text != src
