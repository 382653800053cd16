"""The port's top-k retrieval (ops/topk.py, ops/cuda_mips.py) against the JAX
package's on the CPU. The JAX fused lane runs its Pallas kernel in interpret
mode; the port's fused lane runs its kernel's plain version (CPU tensors).

Tolerances: f32 scores within rtol 1e-6 (the two frameworks sum the products
in different orders, which moves a score by an ulp or so) and identical
indices; bf16 as in ``torch_parity.assert_topk_bf16_close``. The per-block
lane (``method="pallas"``) is held to the Pallas kernel run in interpret mode:
indices equal, scores within 1e-5.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from movie_recommender_system_with_gnns_tpu.ops import topk as J
from movie_recommender_system_with_gnns_tpu.ops.pallas_mips import (
    mips_topk_fused as j_fused,
)
from movie_recommender_system_with_gnns_tpu.ops.pallas_mips import (
    _score_chunkmax_kernel,
    mips_topk_pallas,
)
from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_mips
from movie_recommender_system_with_gnns_tpu_torch.ops import topk as T
from torch_parity import assert_topk_bf16_close, bf16_ulp


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(rng, nq, n, d, p_mask=0.1):
    q = rng.standard_normal((nq, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    mask = rng.random((nq, n)) < p_mask
    # ban each query's best item too (the case exclusion exists for)
    mask[np.arange(nq), (q @ c.T).argmax(1)] = True
    return q, c, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["twophase", "blocked", "flat", "fused", "auto"])
def test_mips_topk_f32_matches_jax(rng, method, masked):
    q, c, mask = _inputs(rng, 21, 1000, 16)
    kw = dict(k=10, method=method)
    if method == "blocked":
        kw["block"] = 256
    if method == "fused":
        kw["score_dtype"] = "float32"
    s_j, i_j = J.mips_topk(jnp.asarray(q), jnp.asarray(c),
                           exclude_mask=jnp.asarray(mask) if masked else None, **kw)
    s_t, i_t = T.mips_topk(_t(q), _t(c), exclude_mask=_t(mask) if masked else None, **kw)
    assert s_t.dtype == torch.float32 and s_t.shape == (21, 10)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-7)
    if masked:
        assert not mask[np.arange(21)[:, None], i_t.numpy()].any()


@pytest.mark.parametrize("mode", ["none", "int8", "packed"])
@pytest.mark.parametrize("n", [1000, 777])
def test_fused_bf16_matches_jax(rng, n, mode):
    q, c, mask = _inputs(rng, 33, n, 32)
    kw = {}
    if mode == "int8":
        kw = {"exclude_mask": mask}
    elif mode == "packed":
        rows, cols = np.nonzero(mask)
        kw = {"exclude_mask_packed": np.asarray(J.pack_mask_tiles(
            jnp.asarray(rows), jnp.asarray(cols), num_rows=33, num_items=n))}
    s_j, i_j = j_fused(jnp.asarray(q), jnp.asarray(c), k=11,
                       **{key: jnp.asarray(v) for key, v in kw.items()})
    s_t, i_t = cuda_mips.mips_topk_fused(_t(q), _t(c), k=10,
                                         **{key: _t(v) for key, v in kw.items()})
    assert_topk_bf16_close(s_t.numpy(), i_t.numpy(), np.asarray(s_j), np.asarray(i_j))
    assert (i_t.numpy() < n).all()
    if mode != "none":
        assert not mask[np.arange(33)[:, None], i_t.numpy()].any()


def test_fused_one_chunk_holds_all_winners(rng):
    """All global top-k in ONE 128-column chunk: the exactness edge case of
    chunk containment."""
    c = rng.standard_normal((1024, 8)).astype(np.float32) * 0.01
    q = rng.standard_normal((2, 8)).astype(np.float32)
    c[256:266] = q[0] * 10 + rng.standard_normal((10, 8)).astype(np.float32) * 0.1
    s_j, i_j = J.mips_topk(jnp.asarray(q), jnp.asarray(c), k=11, method="fused")
    s_t, i_t = T.mips_topk(_t(q), _t(c), k=10, method="fused")
    assert_topk_bf16_close(s_t.numpy(), i_t.numpy(), np.asarray(s_j), np.asarray(i_j))
    assert set(i_t[0].tolist()) == set(range(256, 266))


def test_fused_fewer_survivors_than_k_matches_jax(rng):
    """Fewer than k unmasked columns: the rounded sentinel and the pad
    indices come back exactly as from the JAX kernel."""
    q, c, _ = _inputs(rng, 3, 200, 16)
    mask = np.ones((3, 200), bool)
    mask[:, :4] = False
    s_j, i_j = j_fused(jnp.asarray(q), jnp.asarray(c), k=10,
                       exclude_mask=jnp.asarray(mask))
    s_t, i_t = cuda_mips.mips_topk_fused(_t(q), _t(c), k=10, exclude_mask=_t(mask))
    np.testing.assert_array_equal(i_t.numpy()[:, 4:], np.asarray(i_j)[:, 4:])
    np.testing.assert_array_equal(s_t.numpy()[:, 4:], np.asarray(s_j)[:, 4:])
    assert s_t[0, -1].item() == float(torch.tensor(T.NEG_INF, dtype=torch.bfloat16))


@pytest.mark.parametrize("num_items,n_tile", [(1000, 2048), (4097, 2048), (3000, 1024)])
def test_pack_mask_tiles_byte_identical(rng, num_items, n_tile):
    keys = np.unique(rng.integers(0, 40 * num_items, 3000))
    rows, cols = (keys // num_items).astype(np.int32), (keys % num_items).astype(np.int32)
    # padding pairs land in the sentinel row
    rows = np.concatenate([rows, np.full(5, 40, np.int32)])
    cols = np.concatenate([cols, np.zeros(5, np.int32)])
    j = np.asarray(J.pack_mask_tiles(jnp.asarray(rows), jnp.asarray(cols),
                                     num_rows=40, num_items=num_items, n_tile=n_tile))
    t = T.pack_mask_tiles(_t(rows), _t(cols), 40, num_items, n_tile)
    assert t.dtype == torch.uint8 and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), j)
    dense = np.zeros((40, -(-num_items // n_tile) * n_tile), bool)
    dense[rows[:-5], cols[:-5]] = True
    np.testing.assert_array_equal(cuda_mips.unpack_mask_tiles(t, n_tile).numpy(), dense)


def test_seen_mask_from_pairs_matches_jax():
    rows = np.array([0, 0, 2, 3, 4, 4, 4], np.int32)
    cols = np.array([1, 5, 3, 0, 2, 2, 6], np.int32)
    j = np.asarray(J.seen_mask_from_pairs(jnp.asarray(rows), jnp.asarray(cols),
                                          num_rows=4, num_cols=7))
    t = T.seen_mask_from_pairs(_t(rows), _t(cols), 4, 7)
    assert t.dtype == torch.int8
    np.testing.assert_array_equal(t.numpy(), j)


def test_tie_order_matches_jax(rng):
    """Exact ties: lax.top_k puts the lower position first, at both levels of
    the two-phase selection and in merge_topk."""
    s = rng.integers(0, 4, (6, 700)).astype(np.float32)
    vj, ij = J.twophase_select(jnp.asarray(s), 10)
    vt, it = T.twophase_select(_t(s), 10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ps = rng.integers(0, 3, (4, 6, 5)).astype(np.float32)
    pi = rng.integers(0, 1000, (4, 6, 5)).astype(np.int32)
    mj = J.merge_topk(jnp.asarray(ps), jnp.asarray(pi), 7)
    mt = T.merge_topk(_t(ps), _t(pi), 7)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_postfilter_matches_jax(rng):
    nq, ni = 40, 600
    q, c, _ = _inputs(rng, nq, ni, 16)
    lens = rng.integers(0, 9, nq)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    items = rng.integers(0, ni, indptr[-1]).astype(np.int32)
    excl_j = J.excl_matrix_from_pairs(indptr, items, 16)
    excl_t = T.excl_matrix_from_pairs(indptr, items, 16)
    np.testing.assert_array_equal(excl_t, excl_j)
    s_j, i_j = J.mips_topk_postfilter(jnp.asarray(q), jnp.asarray(c),
                                      jnp.asarray(excl_j), k=6)
    s_t, i_t = T.mips_topk_postfilter(_t(q), _t(c), _t(excl_t), k=5)
    assert_topk_bf16_close(s_t.numpy(), i_t.numpy(), np.asarray(s_j), np.asarray(i_j))
    with pytest.raises(ValueError, match="l_pad"):
        T.excl_matrix_from_pairs(indptr, items, int(lens.max()) - 1)


def test_full_sort_scores_matches_jax(rng):
    q, c, _ = _inputs(rng, 5, 50, 8)
    np.testing.assert_allclose(T.full_sort_scores(_t(q), _t(c)).numpy(),
                               np.asarray(J.full_sort_scores(jnp.asarray(q), jnp.asarray(c))),
                               rtol=1e-5, atol=1e-6)


def test_unported_and_rejected_options(rng):
    q, c, _ = _inputs(rng, 4, 100, 8)
    with pytest.raises(ValueError, match="score_dtype is not supported"):
        T.mips_topk(_t(q), _t(c), k=3, method="pallas", score_dtype="bfloat16")
    with pytest.raises(ValueError, match="k <= block"):
        T.mips_topk(_t(q), _t(c), k=65, method="pallas", block=64)
    with pytest.raises(ValueError):
        T.mips_topk(_t(q), _t(c), k=3, method="fused", block=64)
    with pytest.raises(ValueError):
        T.mips_topk(_t(q), _t(c), k=3, method="fused", recall_target=0.9)
    with pytest.raises(ValueError, match="unknown method"):
        T.mips_topk(_t(q), _t(c), k=3, method="nope")
    with pytest.raises(ValueError, match="packed mask width"):
        cuda_mips.mips_topk_fused(_t(q), _t(c), k=3,
                                  exclude_mask_packed=torch.zeros(4, 8, dtype=torch.uint8))


def test_score_chunkmax_plain_semantics(rng):
    """The kernel's plain version: pad columns and excluded entries hold the
    rounded sentinel, and each chunk max is the max of the ROUNDED tile."""
    q = torch.nn.functional.normalize(_t(rng.standard_normal((128, 16)).astype(np.float32)))
    c = torch.nn.functional.normalize(_t(rng.standard_normal((256, 16)).astype(np.float32)))
    mask = torch.zeros(128, 256, dtype=torch.int8)
    mask[:, 7] = 1
    s, cm = cuda_mips.score_chunkmax(q.bfloat16(), c.bfloat16(), 200, mask=mask)
    neg = torch.tensor(T.NEG_INF, dtype=torch.bfloat16)
    assert s.dtype == cm.dtype == torch.bfloat16 and cm.shape == (128, 2)
    assert (s[:, 200:] == neg).all() and (s[:, 7] == neg).all()
    assert torch.equal(cm, s.view(128, 2, 128).amax(-1))
    ref = (q.bfloat16().float() @ c.bfloat16().float().T).bfloat16()
    assert torch.equal(s[:, 8:200], ref[:, 8:200])
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_mips.score_chunkmax(q.bfloat16().to("meta"), c.bfloat16().to("meta"), 200)


@pytest.mark.parametrize("case", ["plain", "ragged", "masked", "ties", "starved", "k1", "k100"])
def test_block_topk_matches_pallas_interpret(rng, case):
    """``method="pallas"`` on CPU tensors (the kernel's plain version) against
    ``mips_topk_pallas`` in interpret mode: a catalog that is no multiple of
    the block, an exclusion mask that bans each query's best item, exact ties
    (duplicated catalog rows: the lowest index must come first), and rows with
    fewer than k live columns (the dead ranks repeat the first block's first
    column, as the kernel's loop leaves them)."""
    n = 300 if case != "ragged" else 333
    k = {"k1": 1, "k100": 100}.get(case, 7)
    q, c, mask = _inputs(rng, 9, n, 16)
    m = None
    if case == "masked":
        m = mask
    if case == "ties":
        c[150] = c[3]
        c[290] = c[3]
        c[64] = c[65]
    if case == "starved":
        m = np.ones((9, n), bool)
        m[:, [5, 140, 141]] = False      # three live columns, k = 7
        m[4] = True                      # and one query with none at all
    s_j, i_j = mips_topk_pallas(jnp.asarray(q), jnp.asarray(c), k=k, block=128,
                                exclude_mask=None if m is None else jnp.asarray(m))
    s_t, i_t = T.mips_topk(_t(q), _t(c), k=k, block=128, method="pallas",
                           exclude_mask=None if m is None else _t(m))
    assert s_t.dtype == torch.float32 and i_t.dtype == torch.int64
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-5)
    assert (i_t.numpy() < n).all()
    if case == "masked":
        assert not m[np.arange(9)[:, None], i_t.numpy()].any()
    if case == "starved":
        assert (s_t[4] == T.NEG_INF).all() and (i_t[4] == 0).all()
        assert sorted(i_t[0, :3].tolist()) == [5, 140, 141]


def test_block_topk_plain_layout_and_flat_agreement(rng):
    """The per-block candidates: (nb, Q, k) f32 scores and int32 GLOBAL column
    ids, each block's own best first; merged, they equal the flat top-k."""
    q, c, mask = _inputs(rng, 6, 500, 8)
    qn = torch.nn.functional.normalize(_t(q))
    cn = torch.nn.functional.normalize(_t(c))
    os_, oi_ = cuda_mips.mips_block_topk(qn, cn, 4, block=128, mask=_t(mask).to(torch.int8))
    assert os_.shape == oi_.shape == (4, 6, 4)
    assert os_.dtype == torch.float32 and oi_.dtype == torch.int32
    for j in range(4):
        live = os_[j] > T.NEG_INF
        assert ((oi_[j] >= 128 * j) & (oi_[j] < 128 * (j + 1)))[live].all()
    assert (os_[:, :, :-1] >= os_[:, :, 1:]).all()
    s_b, i_b = T.mips_topk(_t(q), _t(c), k=4, block=128, method="pallas", exclude_mask=_t(mask))
    s_f, i_f = T.mips_topk(_t(q), _t(c), k=4, method="flat", exclude_mask=_t(mask))
    assert torch.equal(i_b, i_f)
    np.testing.assert_allclose(s_b.numpy(), s_f.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_mips.mips_block_topk(qn.to("meta"), cn.to("meta"), 4)


def _pallas_score_chunkmax(q, c, n, n_tile, mask=None, packed=None, q_tile=32):
    """The JAX package's ``_score_chunkmax_kernel`` through ``pl.pallas_call``
    in interpret mode, with ``mips_topk_fused``'s BlockSpecs
    (``ops/pallas_mips.py``) at a small query tile: (s (Qp, Np), cm (Np/128,
    Qp)), chunk-major as the TPU kernel stores it."""
    nqp, d = q.shape
    np_ = c.shape[0]
    spec = lambda shape, index: pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)
    in_specs = [spec((q_tile, d), lambda i, j, n_ref: (i, 0)),
                spec((n_tile, d), lambda i, j, n_ref: (j, 0))]
    args = [jnp.asarray(n, jnp.int32).reshape(1), q, c]
    if packed is not None:
        in_specs.append(spec((q_tile, n_tile // 8), lambda i, j, n_ref: (i, j)))
        args.append(packed)
    elif mask is not None:
        in_specs.append(spec((q_tile, n_tile), lambda i, j, n_ref: (i, j)))
        args.append(mask)
    chunk = cuda_mips.CHUNK
    return pl.pallas_call(
        functools.partial(_score_chunkmax_kernel, has_mask=mask is not None or packed is not None,
                          packed_mask=packed is not None),
        interpret=True,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nqp // q_tile, np_ // n_tile), in_specs=in_specs,
            out_specs=(spec((q_tile, n_tile), lambda i, j, n_ref: (i, j)),
                       spec((n_tile // chunk, q_tile), lambda i, j, n_ref: (j, i)))),
        out_shape=(jax.ShapeDtypeStruct((nqp, np_), q.dtype),
                   jax.ShapeDtypeStruct((np_ // chunk, nqp), q.dtype)),
    )(*args)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("n_tile", [1024, 2048])
@pytest.mark.parametrize("mode", ["none", "int8", "packed"])
def test_score_chunkmax_matches_pallas_kernel(rng, mode, n_tile, d):
    """Kernel B2's plain version (the wrapper on CPU tensors) against the TPU
    kernel itself, run in interpret mode, on the same bf16 inputs: a ragged
    catalog whose last valid column lies inside a mask tile, two query tiles.
    Scores within one bf16 ulp (the two frameworks sum the f32 products in
    different orders); pad and masked entries the rounded NEG_INF in both;
    ``cm`` the transposed JAX ``cm`` within one ulp and exactly the max of
    the port's own stored scores."""
    nqp, n = 64, 1500
    np_ = -(-n // n_tile) * n_tile
    q = rng.standard_normal((nqp, d)).astype(np.float32)
    c = np.pad(rng.standard_normal((n, d)).astype(np.float32), ((0, np_ - n), (0, 0)))
    dense = np.zeros((nqp, np_), bool)
    dense[:, :n] = rng.random((nqp, n)) < 0.1
    qj, cj = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(c).astype(jnp.bfloat16)
    qt, ct = _t(q).bfloat16(), _t(c).bfloat16()
    kj, kt = {}, {}
    if mode == "int8":
        kj["mask"] = jnp.asarray(dense.astype(np.int8))
        kt["mask"] = _t(dense.astype(np.int8))
    elif mode == "packed":
        rows, cols = np.nonzero(dense)
        kj["packed"] = J.pack_mask_tiles(jnp.asarray(rows), jnp.asarray(cols), num_rows=nqp,
                                         num_items=n, n_tile=n_tile)
        kt["mask_packed"] = T.pack_mask_tiles(_t(rows), _t(cols), nqp, n, n_tile)
    s_j, cm_j = _pallas_score_chunkmax(qj, cj, n, n_tile, **kj)
    s_t, cm_t = cuda_mips.score_chunkmax(qt, ct, n, n_tile=n_tile, **kt)
    assert s_t.dtype == cm_t.dtype == torch.bfloat16
    assert s_t.shape == (nqp, np_) and cm_t.shape == (nqp, np_ // 128)
    a = s_t.float().numpy()
    b = np.asarray(s_j.astype(jnp.float32))
    ulp = np.maximum(bf16_ulp(a), bf16_ulp(b))
    assert (np.abs(a - b) <= ulp).all()
    neg = float(torch.tensor(T.NEG_INF, dtype=torch.bfloat16))
    dead = np.zeros_like(dense)
    dead[:, n:] = True
    if mode != "none":
        dead |= dense
    assert (a[dead] == neg).all() and (b[dead] == neg).all()
    assert (a[~dead] > neg).all()
    cj_t = np.asarray(cm_j.astype(jnp.float32)).T
    cmt = cm_t.float().numpy()
    assert (np.abs(cmt - cj_t) <= np.maximum(bf16_ulp(cmt), bf16_ulp(cj_t))).all()
    assert torch.equal(cm_t, s_t.view(nqp, -1, 128).amax(-1))


def _probe_variants() -> dict:
    """``VARIANTS`` of ``tools/probe_score_chunkmax.py`` (which imports only
    torch at module level)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_score_chunkmax.py"
    spec = importlib.util.spec_from_file_location("probe_score_chunkmax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


_PROBE_VARIANTS = _probe_variants()


@pytest.mark.parametrize("variant", sorted(_PROBE_VARIANTS))
def test_probe_variant_patches_kernel_source(variant):
    """Each variant of the B2 probe rewrites lines that the kernel source has
    exactly once, and changes the source: the probe follows the kernel."""
    src = (_build.CSRC / "score_chunkmax.cu").read_text()
    text = src
    for line, repl in _PROBE_VARIANTS[variant]:
        assert src.count(line) == 1, line
        text = text.replace(line, repl)
    assert text != src
