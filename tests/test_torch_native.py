"""The port's binding to the host graph runtime (``data/native.py``) against
the JAX package's. Both load a build of the same source: the port compiles
its own byte-equal copy (``csrc/graphcore.cpp`` of ``native/graphcore.cpp``)
into the package's build directory, or a per-user cache where that cannot be
written, the JAX package loads ``native/libgraphcore.so``. Integer outputs
must be EQUAL; float32 CSR weights are computed from the same expression and
must be equal too.
"""

import ctypes
import tomllib
from pathlib import Path

import numpy as np
import pytest

from movie_recommender_system_with_gnns_tpu.data import movielens as jml
from movie_recommender_system_with_gnns_tpu.data import native as jnative
from movie_recommender_system_with_gnns_tpu.data import partition as jpart
from movie_recommender_system_with_gnns_tpu_torch.data import movielens as tml
from movie_recommender_system_with_gnns_tpu_torch.data import native as tnative
from movie_recommender_system_with_gnns_tpu_torch.data import partition as tpart
from movie_recommender_system_with_gnns_tpu_torch.ops import _build

GRAPHS = {"tiny": (60, 90, 2000, 0, 0), "communities": (400, 260, 9000, 3, 6)}


@pytest.fixture(params=sorted(GRAPHS))
def data(request):
    nu, ni, e, seed, comm = GRAPHS[request.param]
    return tml.make_synthetic_movielens(nu, ni, e, seed=seed, num_communities=comm)


def test_jax_package_has_its_native_library():
    """The comparisons below are native against native."""
    assert jnative.available()


def test_library_is_built_into_the_package_build_dir():
    path = _build.library_path("graphcore")
    tnative.member_hashes(np.zeros(1, np.int32), np.zeros(1, np.int32))
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert "native" not in path.relative_to(_build.PACKAGE_DIR).parts
    assert "-march=native" not in _build.HOST_FLAGS


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=5), dict(balance_tol=1.1), dict(refine_rounds=0),
    dict(refine_rounds=8, slack=1.3), dict(refine_rounds=2, slack=1.05, balance_tol=1.2),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
@pytest.mark.parametrize("num_parts", [3, 8])
def test_partition_assignments_equal_jax_native(data, num_parts, kw):
    n = data.num_users + data.num_items
    t = tpart.partition_assignments(data.edge_index, data.num_users, n, num_parts, **kw)
    j = jpart.partition_assignments(data.edge_index, data.num_users, n, num_parts, **kw)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if not {"refine_rounds", "slack"} & set(kw):   # partition_assignments takes these two, the parts function does not
        tp = tpart.partition_bipartite_greedy(data.edge_index, data.num_users, n,
                                              num_parts, **kw)
        jp = jpart.partition_bipartite_greedy(data.edge_index, data.num_users, n,
                                              num_parts, **kw)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)


def test_refinement_keeps_more_edges_than_the_numpy_path():
    """Why the native route is the default: on a graph with communities the
    refiner keeps a multiple of what the NumPy greedy pass keeps."""
    d = tml.make_synthetic_movielens(400, 260, 9000, seed=3, num_communities=6)
    n, total = d.num_users + d.num_items, d.edge_index.shape[1]
    native = tpart.edge_retention(
        tpart.partition_bipartite_greedy(d.edge_index, d.num_users, n, 6), total)
    plain = tpart.edge_retention(
        tpart.partition_bipartite_greedy(d.edge_index, d.num_users, n, 6,
                                         backend="numpy"), total)
    assert native > 1.5 * plain


def test_numpy_backend_rejects_refiner_options(data):
    n = data.num_users + data.num_items
    with pytest.raises(ValueError, match="no refiner"):
        tpart.partition_assignments(data.edge_index, data.num_users, n, 3,
                                    backend="numpy", refine_rounds=4)
    with pytest.raises(ValueError, match="unknown partition backend"):
        tpart.partition_assignments(data.edge_index, data.num_users, n, 3, backend="metis")


def test_graphcore_source_is_a_byte_equal_copy():
    """The port builds its own copy of the JAX package's source, so an
    installed port needs nothing outside its package; the two copies cannot
    drift apart, or the two partitions would."""
    repo = _build.PACKAGE_DIR.parent
    assert _build.HOST_SOURCES["graphcore"] == _build.CSRC / "graphcore.cpp"
    assert ((_build.CSRC / "graphcore.cpp").read_bytes()
            == (repo / "native" / "graphcore.cpp").read_bytes())


def test_package_data_lists_the_port_sources():
    repo = _build.PACKAGE_DIR.parent
    cfg = tomllib.loads((repo / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"][_build.PACKAGE_DIR.name]
    sources = sorted(p.name for p in _build.CSRC.iterdir())
    assert sources and all(any(Path("csrc", n).match(pat) for pat in patterns)
                           for n in sources)
    assert {"bpr_tile.cu", "sorted_index_add.cu", "graphcore.cpp"} <= set(sources)


@pytest.mark.parametrize("cache", ["xdg", "home"])
def test_unwritable_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch, cache):
    """With the package's build directory unwritable (here: under a plain
    file), the library lands in the per-user cache and the partition still
    equals the JAX package's."""
    blocker = tmp_path / "package"
    blocker.write_text("a file, so nothing can be made below it\n")
    if cache == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        root = tmp_path / "xdg"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        root = tmp_path / "home" / ".cache"
    chosen = _build.choose_build_dir(blocker / "build")
    assert chosen.parent == root / _build.PACKAGE_DIR.name
    assert _build.choose_build_dir(tmp_path / "fresh" / "build") == tmp_path / "fresh" / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", chosen)
    monkeypatch.setattr(_build, "_LIBS", {})
    data = tml.make_synthetic_movielens(*GRAPHS["tiny"][:3], seed=0)
    n = data.num_users + data.num_items
    t = tpart.partition_assignments(data.edge_index, data.num_users, n, 3)
    j = jpart.partition_assignments(data.edge_index, data.num_users, n, 3)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert _build.library_path("graphcore").parent == chosen
    assert _build.library_path("graphcore").exists()
    assert not (blocker.parent / "package" / "build").exists() and blocker.is_file()


def test_default_partition_raises_when_the_library_cannot_be_built(
        data, tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile makes the default
    call raise with the compiler's message."""
    broken = tmp_path / "graphcore.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "graphcore", broken)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    n = data.num_users + data.num_items
    with pytest.raises(RuntimeError, match="native build failed(.|\n)*error"):
        tpart.partition_assignments(data.edge_index, data.num_users, n, 3)
    # the NumPy path stays reachable by asking for it
    pu, pi = tpart.partition_assignments(data.edge_index, data.num_users, n, 3,
                                         backend="numpy")
    assert pu.shape == (data.num_users,) and pi.shape == (data.num_items,)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    source = tmp_path / "graphcore.cpp"
    source.write_text("// another source, so no cached library matches\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "graphcore", source)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tnative.member_hashes(np.zeros(1, np.int32), np.zeros(1, np.int32))


def test_build_csr_to_undirected_member_hashes_equal_jax(data):
    n = data.num_users + data.num_items
    src, dst = data.edge_index
    for a, b in zip(tnative.build_csr(src, dst, n), jnative.build_csr(src, dst, n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fwd = src < data.num_users
    np.testing.assert_array_equal(
        tnative.to_undirected(src[fwd], dst[fwd], n),
        jnative.to_undirected(src[fwd], dst[fwd], n))
    np.testing.assert_array_equal(tnative.to_undirected(src[fwd], dst[fwd], n),
                                  data.edge_index)
    u, it = tpart.forward_half(data.edge_index, data.num_users)
    np.testing.assert_array_equal(tnative.member_hashes(u, it),
                                  jnative.member_hashes(u, it))


def _write_csvs(tmp_path, rng, rows=500):
    users = rng.integers(1, 40, rows)
    movies = rng.integers(1, 70, rows)
    ratings = rng.choice([0.5, 2.0, 3.5, 4.0, 4.5, 5.0], rows)
    lines = ["userId,movieId,rating,timestamp"] + [
        f"{u},{m},{r},{1000 + i}" for i, (u, m, r) in enumerate(zip(users, movies, ratings))]
    (tmp_path / "ratings.csv").write_text("\n".join(lines) + "\n")
    ids = np.unique(movies)
    (tmp_path / "movies.csv").write_text(
        "movieId,title,genres\n" + "".join(f"{m},Movie {m},Drama\n" for m in ids))
    return str(tmp_path / "ratings.csv"), str(tmp_path / "movies.csv")


def test_load_ratings_csv_equals_jax_and_pandas(tmp_path, rng):
    ratings, movies = _write_csvs(tmp_path, rng)
    for a, b in zip(tnative.load_ratings_csv(ratings, 4.0),
                    jnative.load_ratings_csv(ratings, 4.0)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tnative.load_ratings_csv(str(tmp_path / "absent.csv"), 4.0)
    j = jml.load_movielens(ratings, movies)
    for reader in ("native", "pandas"):
        t = tml.load_movielens(ratings, movies, reader=reader)
        assert (t.num_users, t.num_items) == (j.num_users, j.num_items)
        np.testing.assert_array_equal(t.edge_index, j.edge_index)
        np.testing.assert_array_equal(t.user_ids, j.user_ids)
        np.testing.assert_array_equal(t.movie_ids, j.movie_ids)
    with pytest.raises(ValueError, match="unknown reader"):
        tml.load_movielens(ratings, movies, reader="arrow")


def test_every_bound_function_declares_its_signature():
    lib = tnative._library()
    for name in ("gc_build_csr", "gc_partition_greedy", "gc_partition_refine",
                 "gc_partition_balance", "gc_to_undirected", "gc_member_hashes",
                 "gc_count_csv_lines", "gc_load_ratings_csv"):
        fn = getattr(lib, name)
        assert fn.argtypes is not None and fn.restype is ctypes.c_int64
