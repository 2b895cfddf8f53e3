"""The port's clustering (``deeplearning4j_tpu_torch/clustering``) against
the JAX package's on the same seeded numpy inputs, on the CPU: k-means'
Lloyd step and fit, the trees, the exact t-SNE gradient and embedding,
and Barnes-Hut t-SNE's kNN, beta search, both iteration routes and its
exact-route embedding; then JAX's purity bars and seeded determinism on
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import bhtsne as jbh
from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import trees as jtrees
from deeplearning4j_tpu.clustering import tsne as jts
from deeplearning4j_tpu_torch.clustering import bhtsne as pbh
from deeplearning4j_tpu_torch.clustering import kmeans as pkm
from deeplearning4j_tpu_torch.clustering import trees as ptrees
from deeplearning4j_tpu_torch.clustering import tsne as pts
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts

CPU = "cpu"
#: relative L2 of the port's f32 results against JAX's: the same f32
#: operations, summed in other orders (matmuls, the segment sum)
TOL32 = 1e-5
#: relative L2 of the port's f64 t-SNE gradient against JAX's
TOL64 = 1e-10
#: relative L2 of the exact t-SNE embedding (f64): the port's gradient is
#: JAX's to ~1e-15 a step, and the iteration carries that difference. At
#: lr 200 on 60 points it is chaotic: the difference grows ~3x an
#: iteration (6e-7 at iteration 20, O(1) by iteration 31, where gains
#: start to flip), so lr 200 is held over 20 iterations and the 100
#: iterations run at lr 10, where the iteration contracts (~1e-11)
TSNE_TOL = 1e-8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(seed, n, d, k, spread=0.5, dup=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (k, d)).astype(np.float32)
    labels = rng.integers(0, k, n)
    X = centers[labels] + rng.normal(0, spread, (n, d)).astype(np.float32)
    if dup:                              # exact copies of the first rows
        X[n - dup:] = X[:dup]
    return X.astype(np.float32), labels


# ----------------------------------------------------------------- k-means
def test_lloyd_step_matches_jax():
    X, _ = _blobs(0, 200, 8, 5)
    C = X[np.random.default_rng(1).choice(200, 5, replace=False)]
    C[4] = 100.0                         # a centre that keeps no point
    want = jkm._lloyd_step(jnp.asarray(X), jnp.asarray(C), 5)
    got = pkm._lloyd_step(_t(X), _t(C), 5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert _rel(got[0].numpy(), want[0]) <= 1e-6
    np.testing.assert_array_equal(got[0].numpy()[4], C[4])
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * abs(float(want[2]))


@pytest.mark.parametrize("k,seed", [(3, 0), (5, 7)])
def test_kmeans_apply_to_matches_jax(k, seed):
    X, _ = _blobs(seed, 300, 4, k)
    want_a, want_c = jkm.KMeansClustering(k, seed=seed).apply_to(X)
    km = pkm.KMeansClustering(k, seed=seed, device=CPU)
    before = fetch_counts().get("kmeans.cost", 0)
    got_a, got_c = km.apply_to(X)
    np.testing.assert_array_equal(got_a, want_a)
    assert _rel(got_c, want_c) <= 1e-6
    assert fetch_counts()["kmeans.cost"] - before == km.iterations_
    np.testing.assert_array_equal(km.predict(X[:50]),
                                  jkm.KMeansClustering.predict(
                                      type("K", (), {"centers": want_c})(),
                                      X[:50]))
    assert pkm.KMeansClustering.setup(k, device=CPU).k == k


# ------------------------------------------------------------------- trees
@pytest.mark.parametrize("dim", [2, 3, 5])
def test_kd_and_vp_trees_match_jax(dim):
    rng = np.random.default_rng(dim)
    pts = rng.normal(size=(150, dim))
    pts[-5:] = pts[:5]                   # duplicates
    queries = rng.normal(size=(6, dim))
    pk, jk = ptrees.KDTree(pts), jtrees.KDTree(pts)
    pv, jv = ptrees.VPTree(pts, seed=3), jtrees.VPTree(pts, seed=3)
    for q in queries:
        assert pk.nn(q) == jk.nn(q)
        assert pk.knn(q, 7) == jk.knn(q, 7)
        assert pv.knn(q, 7) == jv.knn(q, 7)


@pytest.mark.parametrize("cls,dim", [("QuadTree", 2), ("SpTree", 3)])
def test_bh_trees_match_jax(cls, dim):
    rng = np.random.default_rng(11)
    Y = rng.normal(size=(120, dim))
    Y[-4:] = Y[:4]
    pt, jt = getattr(ptrees, cls).build(Y), getattr(jtrees, cls).build(Y)
    assert pt.size == jt.size
    for i in (0, 50, 119):
        for theta in (0.0, 0.5):
            gn, gs = pt.compute_non_edge_forces(Y[i], theta)
            wn, ws = jt.compute_non_edge_forces(Y[i], theta)
            np.testing.assert_array_equal(gn, wn)
            assert gs == ws


# ------------------------------------------------------------ exact t-SNE
def test_tsne_grad_f64_matches_jax():
    rng = np.random.default_rng(3)
    Y = rng.normal(size=(40, 2))
    P = rng.random((40, 40))
    P = (P + P.T) / P.sum()
    gw, kw = jts._tsne_grad(jnp.asarray(Y), jnp.asarray(P))
    gg, kg = pts._tsne_grad(_t(Y), _t(P))
    assert gg.dtype == torch.float64
    assert _rel(gg.numpy(), gw) <= TOL64
    assert abs(float(kg) - float(kw)) <= TOL64 * abs(float(kw))


@pytest.mark.parametrize("lr,n_iter", [(10.0, 100), (200.0, 20)])
def test_tsne_calculate_matches_jax(lr, n_iter):
    X, _ = _blobs(5, 60, 6, 3)
    j = jts.Tsne(perplexity=10, n_iter=n_iter, learning_rate=lr)
    p = (pts.Tsne.Builder().perplexity(10).set_max_iter(n_iter).theta(0.5)
         .learning_rate(lr).device(CPU).build())
    want, got = j.calculate(X), p.calculate(X)
    assert got.dtype == np.float64
    assert _rel(got, want) <= TSNE_TOL
    assert abs(p.kl_divergence_ - j.kl_divergence_) <= \
        TSNE_TOL * abs(j.kl_divergence_)
    np.testing.assert_array_equal(
        pts._perplexity_search(np.square(X[:20, None] - X[None, :20]).sum(-1),
                               5.0),
        jts._perplexity_search(np.square(X[:20, None] - X[None, :20]).sum(-1),
                               5.0))


# ------------------------------------------------------ Barnes-Hut t-SNE
@pytest.mark.parametrize("n,k,chunk,dup", [(120, 10, 32, 6), (200, 30, 64, 40),
                                           (50, 12, 16, 20)])
def test_knn_chunked_matches_jax(n, k, chunk, dup):
    """Duplicated rows tie at distance 0: the ties' order and, where a
    row has more copies than k + 1 places, the self-drop's fallback to
    column 0 are both exercised."""
    X, _ = _blobs(n, n, 6, 3, dup=dup)
    if dup > k:                          # a block of identical rows
        X[:dup] = X[0]
    wi, wd = jbh._knn_chunked(X, k, chunk=chunk)
    gi, gd = pbh._knn_chunked(X, k, chunk=chunk, device=CPU)
    np.testing.assert_array_equal(gi, wi)
    assert np.max(np.abs(gd - wd)) <= 1e-5 * max(1.0, np.abs(wd).max())
    p = pbh._beta_search(gd.astype(np.float64), 8.0)
    np.testing.assert_array_equal(p, jbh._beta_search(gd.astype(np.float64),
                                                      8.0))
    np.testing.assert_array_equal(pbh._beta_search(wd, 5.0),
                                  jbh._beta_search(wd, 5.0))


def _edge_case(n, seed):
    X, _ = _blobs(seed, n, 5, 3)
    k = 30
    idx, d2 = jbh._knn_chunked(X, k, chunk=64)
    p = jbh._beta_search(d2, 10.0)
    rows = np.repeat(np.arange(n), k)
    cols = idx.reshape(-1)
    vals = (p.reshape(-1) / (2.0 * n)).astype(np.float32)
    src = np.concatenate([rows, cols]).astype(np.int64)
    dst = np.concatenate([cols, rows]).astype(np.int64)
    w = np.concatenate([vals, vals])
    rng = np.random.default_rng(seed + 1)
    Y = rng.normal(0, 1.0, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 0.1, (n, 2)).astype(np.float32)
    gains = (1.0 + rng.random((n, 2))).astype(np.float32)
    return Y, vel, gains, src, dst, w


@pytest.mark.parametrize("momentum,ex", [(0.5, 12.0), (0.8, 1.0)])
def test_iteration_exact_matches_jax(momentum, ex):
    """N 300 in chunks of 128: the last block is padded."""
    args = _edge_case(300, 4)
    want = jbh._iteration_exact(*[jnp.asarray(a) for a in args], momentum,
                                200.0, ex, chunk=128)
    got = pbh._iteration_exact(*[_t(a) for a in args], momentum, 200.0, ex,
                               chunk=128)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= TOL32


def test_iteration_ns_given_matches_jax():
    """The port on JAX's own draw from the same key."""
    args = _edge_case(300, 8)
    key = jax.random.PRNGKey(5)
    want = jbh._iteration_ns(*[jnp.asarray(a) for a in args], key, 16, 0.5,
                             200.0, 12.0)
    idx = np.asarray(jax.random.randint(key, (300, 16), 0, 299))
    got = pbh._iteration_ns_given(*[_t(a) for a in args], _t(idx), 0.5,
                                  200.0, 12.0)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL32


@pytest.mark.parametrize("n_iter", [2, 50])
def test_bhtsne_exact_route_matches_jax(n_iter):
    """N 300 on the exact route. The edge list is JAX's (the same pairs,
    weights at 1e-5). The f32 iteration from the 1e-4-scale initial draw
    is chaotic in both packages: a 1e-7 difference (f32 against f64, in
    either package) grows ~2x an iteration and reaches O(1) by iteration
    20, and a 1e-6 shift of the input moves the port's own 50-iteration
    embedding as far. So two iterations are held at 1e-4 and fifty by
    JAX's purity bar, which both embeddings must clear within 0.02 of
    each other."""
    X, labels = _blobs(21, 300, 4, 3)
    ts = (pbh.BarnesHutTsne.Builder().perplexity(10).set_max_iter(n_iter)
          .device(CPU).build())
    src, dst, w = (a.numpy() for a in ts._edges(X))
    idx, d2 = jbh._knn_chunked(X, 30)
    vals = (jbh._beta_search(d2, 10.0).reshape(-1) / 600.0).astype(
        np.float32)
    rows = np.repeat(np.arange(300), 30)
    jsrc = np.concatenate([rows, idx.reshape(-1)])
    jdst = np.concatenate([idx.reshape(-1), rows])
    jw = np.concatenate([vals, vals])
    # the same (src, dst) pairs: two neighbours whose distances differ by
    # less than the expansion's rounding (7.6e-6 at row 268) may swap
    # places within a row; the weights are exp(-beta d2), which multiplies
    # the distances' rounding difference (<= 3e-5 of 4.1) by beta d2
    got_o, want_o = np.lexsort((dst, src)), np.lexsort((jdst, jsrc))
    np.testing.assert_array_equal(src[got_o], jsrc[want_o])
    np.testing.assert_array_equal(dst[got_o], jdst[want_o])
    assert _rel(w[got_o], jw[want_o]) <= 1e-4
    want = jbh.BarnesHutTsne(perplexity=10, n_iter=n_iter).calculate(X)
    got = ts.calculate(X)
    assert got.dtype == np.float32
    if n_iter == 2:
        assert _rel(got, want) <= 1e-4
    else:
        pw, pg = _purity(want, labels, 3), _purity(got, labels, 3)
        assert min(pw, pg) > 0.9 and abs(pw - pg) <= 0.02


def _purity(Y, labels, k):
    ems = np.array([Y[labels == i].mean(0) for i in range(k)])
    pred = np.argmin(((Y[:, None, :] - ems[None]) ** 2).sum(-1), 1)
    return (pred == labels).mean()


@pytest.mark.parametrize("route", ["exact", "negative_sampling"])
def test_bhtsne_purity_bars(route):
    """tests/test_bhtsne.py's bars on the port: 0.95 exact, 0.8 sampled."""
    n, bar = (400, 0.95) if route == "exact" else (500, 0.8)
    X, labels = _blobs(12345, n, 4, 3)
    kw = {} if route == "exact" else {"exact_threshold": 0,
                                      "negative_samples": 96}
    Y = pbh.BarnesHutTsne(perplexity=20, n_iter=400, device=CPU,
                          **kw).calculate(X)
    assert _purity(Y, labels, 3) > bar


def test_bhtsne_negative_sampling_is_seeded():
    X, _ = _blobs(2, 400, 6, 4)
    runs = [pbh.BarnesHutTsne(perplexity=15, n_iter=30, exact_threshold=0,
                              seed=s, device=CPU).calculate(X)
            for s in (7, 7, 8)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert np.isfinite(runs[0]).all()


def test_attraction_is_segment_sum():
    """The attractive sum through the segment update equals JAX's
    segment_sum of the same edge forces."""
    Y, _, _, src, dst, w = _edge_case(120, 3)
    got = pbh._attraction(_t(Y), _t(src), _t(dst), _t(w), 12.0).numpy()
    diff = Y[src] - Y[dst]
    q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
    want = jax.ops.segment_sum(jnp.asarray((w * 12.0 * q)[:, None] * diff),
                               jnp.asarray(src), num_segments=120)
    assert _rel(got, want) <= TOL32


def test_builders_and_setup():
    ts = (pbh.BarnesHutTsne.Builder().perplexity(12).theta(0.3)
          .learning_rate(100).set_max_iter(77).device(CPU).build())
    assert ts.perplexity == 12 and ts.theta == 0.3
    assert ts.learning_rate == 100 and ts.n_iter == 77
    assert ts.device.type == "cpu"


def test_tsne_separates_blobs():
    """tests/test_core_tooling.py's t-SNE bar on the port."""
    rng = np.random.default_rng(12345)
    centers = rng.normal(0, 8.0, (2, 10))
    labels = np.repeat(np.arange(2), 30)
    X = (centers[labels] + rng.normal(size=(60, 10))).astype(np.float32)
    ts = (pts.Tsne.Builder().perplexity(10).learning_rate(100.0)
          .set_max_iter(400).device(CPU).build())
    Y = ts.calculate(X)
    c0, c1 = Y[labels == 0].mean(axis=0), Y[labels == 1].mean(axis=0)
    intra = np.mean(np.linalg.norm(Y[labels == 0] - c0, axis=1))
    assert np.linalg.norm(c0 - c1) > 2 * intra
    assert np.isfinite(ts.kl_divergence_)
