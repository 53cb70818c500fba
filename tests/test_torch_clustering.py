"""The port's nearest neighbours, k-means, LSH and k-NN server against the
JAX package's on the CPU.

The copied trees (``VPTree``, ``KDTree``, ``SpTree``, ``QuadTree``) and the
cluster objects give the reference's outputs on the reference's own test
inputs (``tests/test_clustering.py``), one parametrised test a module.
``pairwise_distance`` matches for all 8 metrics within 1e-5 ×
max(1, largest entry); ``knn`` and ``search_excluding_self`` give the
reference's indices on data with duplicate rows and equal distances
(small integers, whose distances both packages compute exactly), ties
lowest index first. KMeans from the same seed gives the same seeding,
centres within 1e-5, the same assignments, costs within 1e-5 relative and
the same ``ClusterSet``. LSH gives the same buckets and answers. Both
packages' servers run in process on port 0 over the same corpus and answer
with the same JSON and status codes.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as R
from deeplearning4j_tpu.clustering import server as r_server
from deeplearning4j_tpu_torch import clustering as P
from deeplearning4j_tpu_torch.clustering import server as p_server
from deeplearning4j_tpu_torch.observe.metrics import MetricsRegistry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jitted_reference_distances():
    """The reference's ``pairwise_distance`` under one ``jax.jit`` a metric
    and shape, as its ``knn`` already runs it, where its k-means seeding,
    LSH and cluster objects call it op by op (each op compiling per shape):
    the same function, a tenth of the compilations."""
    import jax

    from deeplearning4j_tpu.clustering import kmeans as r_kmeans, lsh as r_lsh

    eager = R.bruteforce.pairwise_distance
    jitted = jax.jit(eager, static_argnames=("distance",))
    patched = (R.bruteforce, r_kmeans, r_lsh)
    for m in patched:
        m.pairwise_distance = jitted
    yield
    for m in patched:
        m.pairwise_distance = eager


def _blobs(n_per=30, centers=((0, 0), (10, 10), (-10, 10)), d=2, seed=0):
    """The reference tests' blobs."""
    rng = np.random.default_rng(seed)
    pts = []
    for c in centers:
        base = np.zeros(d)
        base[: len(c)] = c
        pts.append(base + rng.standard_normal((n_per, d)))
    return np.concatenate(pts).astype(np.float32)


def _grid(n=80, d=5, seed=0):
    """Small-integer points with duplicate rows: distances are exact in
    both packages and many are equal."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    x[[10, 20, 33]] = x[3]
    x[[41, 42]] = x[7]
    return x


# ------------------------------------------------------------------ trees
def _vptree(m):
    pts = _blobs(n_per=25, d=6)
    tree = m.VPTree(pts)
    rng = np.random.default_rng(3)
    out = [tree.search(rng.standard_normal(6).astype(np.float32), 7) for _ in range(5)]
    out.append(tree.search(pts[4], 1))
    out.append(m.VPTree(_blobs(n_per=10, d=4), distance="cosine").search(pts[0][:4] * 3.0, 3))
    grid = _grid()
    for dist in ("euclidean", "manhattan", "chebyshev", "dot", "sqeuclidean"):
        out.append(m.VPTree(grid, distance=dist, seed=2).search(grid[3], 9))
    fs = m.VPTreeFillSearch(m.VPTree(_blobs(n_per=5)), 9, _blobs(n_per=5)[0])
    fs.run()
    return out + [(fs.distances, fs.results)]


def _kdtree(m):
    tree = m.KDTree(2)
    for p in [(0, 0), (1, 1), (5, 5), (2, 2)]:
        tree.insert(p)
    out = [tree.nn((1.1, 1.1)), tree.size, tree.range((0.5, 0.5), (3, 3))]
    out += [tree.delete((1, 1)), tree.delete((9, 9)), tree.size, tree.nn((1, 1))]
    big = m.KDTree(3)
    for p in _blobs(n_per=20, d=3):
        big.insert(p)
    out.append(big.knn(np.array([0.5, 0.5, 0.5], np.float32), 5))
    r = m.HyperRect((0, 0), (2, 2))
    out += [r.contains(np.array([1, 1])), r.contains(np.array([3, 1])),
            r.min_distance(np.array([3, 1])), m.HyperRect.infinite(2).lower,
            r.get_lower_half(0, 1.0).upper, r.get_upper_half(1, 0.5).lower]
    return out


def _sptree(m):
    out = []
    for pts in (np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64), np.zeros((10, 2)),
                np.random.default_rng(7).standard_normal((40, 2)),
                np.random.default_rng(8).standard_normal((25, 3))):
        tree = m.SpTree(pts)
        out += [tree.cum_size, tree.center_of_mass, tree.depth()]
        for theta in (0.0, 0.5):
            neg = np.zeros(pts.shape[1])
            out += [tree.compute_non_edge_forces(0, theta, neg), neg]
        rows = np.arange(0, 2 * len(pts) + 1, 2)
        cols = (np.arange(2 * len(pts)) * 7) % len(pts)
        pos = np.zeros_like(pts)
        tree.compute_edge_forces(rows, cols, np.linspace(0.1, 1.0, len(cols)), pos)
        out.append(pos)
    return out


def _quadtree(m):
    with pytest.raises(ValueError, match="2-D"):
        m.QuadTree(np.zeros((3, 3)))
    qt = m.QuadTree(np.array([[0, 0], [1, 1], [0.2, 0.8], [0.9, 0.1]]))
    return [qt.cum_size, qt.depth()] + [
        None if c is None else (c.cum_size, c.center_of_mass.tolist())
        for c in (qt.north_west, qt.north_east, qt.south_west, qt.south_east)]


def _clusters(m):
    pts = _blobs(n_per=6)
    points = [m.Point(row, id=f"p{i}") for i, row in enumerate(pts)]
    cs = m.ClusterSet()
    for c in ((0, 0), (10, 10), (-10, 10), (50, 50)):
        cs.add_new_cluster_with_center(np.array(c, np.float32))
    cs.classify_points(points[:12], move_centers=True)
    out = [(pc.cluster.center.tolist(), pc.distance_from_center, pc.new_location)
           for pc in (cs.classify_point(points[i]) for i in (0, 12, 17))]
    out += [cs.cluster_count, cs.get_centers(),
            [c.distance_to_center(points[1]) for c in cs.clusters],
            [[p.id for p in c.points] for c in cs.clusters]]
    out += [len(cs.remove_empty_clusters()), cs.cluster_count,
            [p.array.dtype for p in m.Point.to_points(pts[:2])]]
    cos = m.Cluster(np.array([1.0, 0.0], np.float32), distance="cosine")
    out.append(cos.distance_to_center(m.Point(np.array([0.5, 0.5], np.float32))))
    return out


TREES = {"vptree": _vptree, "kdtree": _kdtree, "sptree": _sptree,
         "quadtree": _quadtree, "cluster": _clusters}


def _same(got, want, path="out"):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, float, np.floating)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("module", list(TREES))
def test_copied_modules_match_the_reference(module):
    got, want = TREES[module](P), TREES[module](R)
    if module == "cluster":
        # the distances come from each package's pairwise_distance
        dist_got, dist_want = got.pop(4), want.pop(4)
        np.testing.assert_allclose(dist_got, dist_want, rtol=1e-6)
        np.testing.assert_allclose(got.pop(0)[1], want.pop(0)[1], rtol=1e-6)
        np.testing.assert_allclose(got.pop(), want.pop(), atol=1e-6)
    _same(got, want)


# ------------------------------------------------------------------ brute force
@pytest.mark.parametrize("metric", list(R.bruteforce.DISTANCES))
def test_pairwise_distance_matches_the_reference(metric):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((20, 8)).astype(np.float32)
    c[4] = q[2]
    if metric == "jaccard":
        q, c = np.abs(q), np.abs(c)
    if metric == "hamming":
        q, c = np.round(q), np.round(c)
    want = np.asarray(R.pairwise_distance(q, c, metric))
    got = P.pairwise_distance(torch.from_numpy(q), torch.from_numpy(c), metric)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL * max(1.0, np.abs(want).max())
    with pytest.raises(ValueError, match="unknown distance"):
        P.pairwise_distance(q, c, "nope")


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan", "chebyshev",
                                    "dot", "hamming"])
def test_knn_on_duplicate_rows_gives_the_reference_s_indices(metric):
    x = _grid()
    q = x[[3, 7, 0, 41, 60]]
    dr, ir = R.knn(q, x, 12, metric)
    dp, ip = P.knn(torch.from_numpy(q), torch.from_numpy(x), 12, metric)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dr))
    assert ip.device.type == "cpu"


def test_search_and_search_excluding_self_give_the_reference_s_indices():
    x = _grid()
    ref = R.BruteForceNearestNeighbors(x, query_chunk=16)
    port = P.BruteForceNearestNeighbors(x, query_chunk=16, device="cpu")
    assert len(port) == len(ref)
    for got, want in ((port.search_excluding_self(6), ref.search_excluding_self(6)),
                      (port.search(x[:30], 9), ref.search(x[:30], 9)),
                      (port.search(x[5], 200), ref.search(x[5], 200))):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    # a point with more duplicates than k + 1: its own row may fall out
    d, i = port.search_excluding_self(2)
    assert 3 not in i[3] and 10 in i[3]
    np.testing.assert_array_equal(i, ref.search_excluding_self(2)[1])


# ------------------------------------------------------------------ KMeans
def _kmeans_data():
    x = _blobs(n_per=80, d=8, centers=((0,) * 8, (6,) * 8, (0, 6, 0, 6, 0, 6, 0, 6)), seed=5)
    return x


KMEANS = {
    "euclidean": dict(cluster_count=3, max_iteration_count=50, seed=1),
    "sqeuclidean": dict(cluster_count=3, max_iteration_count=50, distance="sqeuclidean",
                        seed=1),
    "dot": dict(cluster_count=3, max_iteration_count=10, distance="dot", seed=1),
    "cosine": dict(cluster_count=4, max_iteration_count=20, distance="cosine", seed=2),
    "max_iter_0": dict(cluster_count=2, max_iteration_count=0, seed=0),
    "duplicates": dict(cluster_count=2, max_iteration_count=5, seed=0),
}


@functools.lru_cache(maxsize=None)
def _kmeans_reference(case):
    x = np.tile(np.ones((1, 4), np.float32), (5, 1)) if case == "duplicates" else _kmeans_data()
    km = R.KMeansClustering.setup(**KMEANS[case])
    return x, km, km.fit(x)


@pytest.mark.parametrize("case", list(KMEANS))
def test_kmeans_matches_the_reference(case):
    x, ref, want = _kmeans_reference(case)
    port = P.KMeansClustering.setup(**KMEANS[case], device="cpu")
    got = port.fit(x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert len(port.iteration_costs) == len(ref.iteration_costs)
    np.testing.assert_allclose(port.iteration_costs, ref.iteration_costs, rtol=TOL)
    if case == "dot":
        assert len(set(port.seed_indices)) == 3


def test_kmeans_seeding_equals_the_reference_s():
    x = _kmeans_data()
    for seed in range(4):
        ref = R.KMeansClustering.setup(5, 1, seed=seed)
        port = P.KMeansClustering.setup(5, 1, seed=seed, device="cpu")
        ref.fit(x)
        port.fit(x)
        # one sweep from the seeds: the same first cost means the same seeds
        np.testing.assert_allclose(port.iteration_costs, ref.iteration_costs, rtol=TOL)
        np.testing.assert_array_equal(port.assignments, ref.assignments)
    with pytest.raises(ValueError, match="need >= k"):
        P.KMeansClustering.setup(5, device="cpu").fit(x[:3])
    with pytest.raises(ValueError, match="call fit"):
        P.KMeansClustering(2, device="cpu").assignments


def test_apply_to_gives_the_reference_s_cluster_set():
    pts = _blobs(n_per=15)
    sets = []
    for m, kw in ((R, {}), (P, {"device": "cpu"})):
        points = [m.Point(row, id=f"p{i}") for i, row in enumerate(pts)]
        cs = m.KMeansClustering.setup(3, 50, **kw).applyTo(points)
        sets.append((cs.cluster_count, cs.get_centers(),
                     [[p.id for p in c.points] for c in cs.clusters],
                     cs.classify_point(points[0]).new_location))
    (n_p, c_p, m_p, new_p), (n_r, c_r, m_r, new_r) = sets[1], sets[0]
    assert (n_p, m_p, new_p) == (n_r, m_r, new_r) == (3, m_r, False)
    np.testing.assert_allclose(c_p, c_r, atol=TOL * np.abs(c_r).max())


# ------------------------------------------------------------------ LSH
LSH = {"blobs": dict(hash_length=8, num_tables=6, radius=10.0),
       "recall": dict(hash_length=6, num_tables=8),
       "long": dict(hash_length=16, num_tables=2, seed=3)}


@pytest.mark.parametrize("case", list(LSH))
def test_lsh_matches_the_reference(case):
    pts = _blobs(n_per=60, d=8, centers=((0,) * 8, (20,) * 8))
    ref, port = R.RandomProjectionLSH(**LSH[case]), P.RandomProjectionLSH(**LSH[case],
                                                                          device="cpu")
    ref.make_index(pts)
    port.make_index(pts)
    assert port._tables == ref._tables and port.in_dimensions == ref.in_dimensions
    # |q|^2 - 2 q.c + |c|^2 rounds at the scale of |q|^2: squared distances
    # within TOL of the largest squared norm
    scale = TOL * float((pts.astype(np.float64) ** 2).sum(1).max())
    for i in ((3,) if case == "blobs" else (77,)):
        np.testing.assert_array_equal(port.bucket(pts[i]), ref.bucket(pts[i]))
        for got, want in ((port.search(pts[i]), ref.search(pts[i])),
                          (port.search(pts[i], 4.0), ref.search(pts[i], 4.0)),
                          (port.get_all_nearest_neighbors(pts[i], 5),
                           ref.get_all_nearest_neighbors(pts[i], 5)),
                          (port.get_all_nearest_neighbors(pts[i], 500),
                           ref.get_all_nearest_neighbors(pts[i], 500))):
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0].astype(np.float64) ** 2,
                                       want[0].astype(np.float64) ** 2, rtol=0, atol=scale)
    far = np.full(8, 1e3, np.float32)
    assert port.search(far, 1e-3)[1].size == ref.search(far, 1e-3)[1].size


# ------------------------------------------------------------------ the server
LABELS = [f"v{i}" for i in range(80)]


def _call(url, path, body=None):
    """(status, JSON) of one request; a raw body is sent as it is."""
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


REQUESTS = [("/knn", {"ndarray": 3, "k": 5}), ("/knn", {"ndarray": 41, "k": 5}),
            ("/knn", {"ndarray": 0}), ("/knn", {"ndarray": 7, "k": 500}),
            ("/knnnew", {"ndarray": [1, 0, -1, 2, 0], "k": 6}),
            ("/knnnew", {"ndarray": [0.5, 0.5, 0.5, 0.5, 0.5], "k": 6}),
            ("/labels", None),
            # the reference's 400s and 404s
            ("/knn", {"ndarray": 80, "k": 2}), ("/knn", {"ndarray": -1}),
            ("/knn", {"k": 2}), ("/knn", {"ndarray": 1, "k": "x"}),
            ("/knnnew", {"ndarray": [1, 2], "k": 2}), ("/knn", b"{not json"),
            ("/nope", {"ndarray": 1}), ("/nope", None)]

SERVERS = {"device": dict(), "invert": dict(invert=True), "host": dict(use_device=False),
           "manhattan_no_labels": dict(similarity_function="manhattan", labels=None)}


def _stop(*servers):
    """Stops the servers side by side (each waits out its serving loop's
    poll)."""
    threads = [threading.Thread(target=s.stop) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def _answers(server):
    url = f"http://127.0.0.1:{server.port}"
    return [_call(url, path, body) for path, body in REQUESTS]


@pytest.fixture(scope="module")
def servers():
    """Both packages' servers for every case, started once and stopped side
    by side when the module is done."""
    started = {}
    try:
        for case, extra in SERVERS.items():
            kw = {"labels": LABELS, **extra}
            started[case] = (r_server.NearestNeighborsServer(_grid(), port=0, **kw),
                             p_server.NearestNeighborsServer(_grid(), port=0, device="cpu",
                                                             **kw))
            for s in started[case]:
                s.start()
        yield started
    finally:
        _stop(*(s for pair in started.values() for s in pair))


@pytest.mark.parametrize("case", list(SERVERS))
def test_servers_answer_with_the_reference_s_json(case, servers):
    ref, port = servers[case]
    got, want = _answers(port), _answers(ref)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert got == want


def test_server_main_reads_an_npy_and_counts_requests(tmp_path):
    x = _grid()
    np.save(tmp_path / "pts.npy", x)
    (tmp_path / "labels.txt").write_text("\n".join(LABELS) + "\n")
    argv = ["--ndarrayPath", str(tmp_path / "pts.npy"), "--labelsPath",
            str(tmp_path / "labels.txt"), "--nearestNeighborsPort", "0"]
    metrics = MetricsRegistry()
    counted = p_server.NearestNeighborsServer(x, port=0, device="cpu", metrics=metrics)
    counted.start()
    ref = r_server.NearestNeighborsServer.main(argv)
    port = p_server.NearestNeighborsServer.main(argv, device="cpu")
    try:
        assert port._index.points.device.type == "cpu"
        for path, body in REQUESTS[:7]:
            assert (_call(f"http://127.0.0.1:{port.port}", path, body)
                    == _call(f"http://127.0.0.1:{ref.port}", path, body))
        client = P.server.NearestNeighborsClient(f"http://127.0.0.1:{port.port}/")
        assert client.knn(3, 4) == r_server.NearestNeighborsClient(
            f"http://127.0.0.1:{ref.port}").knn(3, 4)
        assert client.knn_new(x[9], 2)["results"][0] == {"index": 9, "distance": 0.0}
        # the metrics exposition counts each request under its path and status
        url = f"http://127.0.0.1:{counted.port}"
        threads = [threading.Thread(target=_call, args=(url, "/knn", {"ndarray": i, "k": 3}))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert _call(url, "/knn", {"ndarray": 99})[0] == 400
    finally:
        _stop(ref, port, counted)
    text = metrics.exposition()
    assert 'http_requests_total{server="knn",path="/knn",status="200"} 8' in text
    assert 'http_requests_total{server="knn",path="/knn",status="400"} 1' in text
