"""The port's view graph (no networkx) against the JAX package's (networkx
3.x): ``communities.csv``, ``mst_pairs.txt``, ``mst_expanded_pairs.txt`` and
``graph.html`` byte-equal on several databases, among them tie-heavy ones
(equal match counts everywhere), sparse ones with most images unlinked
(networkx then iterates its node filter's set) and disconnected ones; and
the three algorithms against networkx directly on random graphs."""

import random

import networkx as nx
import numpy as np
import pytest

from deep_image_matching_tpu.graph import view_graph as jax_view_graph
from deep_image_matching_tpu_torch import graph as tg
from deep_image_matching_tpu_torch.io.colmap_db import COLMAPDatabase

FILES = ("communities.csv", "mst_pairs.txt", "mst_expanded_pairs.txt", "graph.html")


def _database(path, ids, edges):
    """A COLMAP database with images ``ids`` (in insertion order) and
    verified pairs {(i, j): rows}."""
    db = COLMAPDatabase.connect(path)
    db.create_tables()
    cam = db.add_camera(0, 640, 480, [500.0, 320.0, 240.0])
    for i in ids:
        db.add_image(f"img_{i:04d}.jpg", cam, image_id=i)
    for (i, j), rows in edges.items():
        db.add_two_view_geometry(i, j, np.zeros((rows, 2), np.int64))
    db.commit()
    db.close()
    return path


def _random_edges(rng, ids, p, weights):
    edges = {}
    for a in range(len(ids)):
        for b in range(a + 1, len(ids)):
            if rng.random() < p:
                edges[(ids[a], ids[b])] = int(rng.choice(weights))
    return edges


def _rings(n_rings: int, size: int, rows: int):
    """Rings of equal-weight edges joined by single equal-weight bridges:
    every modularity gain and every spanning-tree weight ties."""
    ids = list(range(1, n_rings * size + 1))
    edges = {}
    for r in range(n_rings):
        ring = ids[r * size:(r + 1) * size]
        for k in range(size):
            a, b = sorted((ring[k], ring[(k + 1) % size]))
            edges[(a, b)] = rows
        if r:
            edges[(ids[(r - 1) * size], ring[size // 2])] = rows
    return ids, edges


def _cases():
    rng = np.random.default_rng(0)
    ids = list(range(1, 41))
    yield "random", ids, _random_edges(rng, ids, 0.3, range(15, 3000))
    ids = list(range(1, 31))
    yield "ties", ids, _random_edges(rng, ids, 0.4, [100])
    yield "few_weights", ids, _random_edges(rng, ids, 0.5, [20, 40])
    yield "rings", *_rings(4, 6, 50)
    # most images unlinked, sparse ids: networkx iterates its filter's set
    ids = [3, 9, 17, 33, 100, 101, 250] + list(range(400, 420))
    yield "sparse_ids", ids, {(3, 17): 40, (17, 100): 40, (9, 250): 40, (3, 100): 41,
                              (9, 17): 40}
    ids = list(range(1, 26))
    edges = _random_edges(rng, ids[:8], 0.7, [30, 30, 31])
    edges.update(_random_edges(rng, ids[10:20], 0.5, [30]))
    yield "components", ids, edges


CASES = {name: (ids, edges) for name, ids, edges in _cases()}


@pytest.mark.parametrize("case", list(CASES))
def test_view_graph_files_equal_jax(tmp_path, case):
    ids, edges = CASES[case]
    db = _database(tmp_path / "database.db", ids, edges)
    jax_view_graph(db, tmp_path / "jax")
    tg.view_graph(db, tmp_path / "port")
    for f in FILES:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_view_graph_without_edges_writes_nothing(tmp_path):
    db = _database(tmp_path / "database.db", [1, 2, 3], {})
    tg.view_graph(db, tmp_path / "port")
    assert not any((tmp_path / "port").iterdir())


def test_algorithms_equal_networkx_on_random_graphs():
    """Communities (sets and order), the tree's edges in order and the
    clustering coefficients bit for bit, on 300 random graphs with few
    distinct weights (ties everywhere) and unlinked images."""
    for seed in range(300):
        rnd = random.Random(seed)
        n = rnd.randint(2, 40)
        G, NG = tg.Graph(), nx.Graph()
        for i in range(1, n + 1):
            G.add_node(i)
            NG.add_node(i)
        active = [i for i in range(1, n + 1) if rnd.random() >= rnd.choice([0.0, 0.6])]
        pairs = [(a, b) for k, a in enumerate(active) for b in active[k + 1:]
                 if rnd.random() < rnd.choice([0.1, 0.4, 1.0])]
        rnd.shuffle(pairs)
        wmax = rnd.choice([1, 2, 3, 500])
        for a, b in pairs:
            w = rnd.randint(1, wmax)
            G.add_edge(a, b, matches=w)
            NG.add_edge(a, b, matches=w)
        if not pairs:
            continue
        AG = NG.subgraph([x for x in NG.nodes() if NG.degree[x] > 0])
        order = tg.subgraph_order(G, [x for x in G.nodes if G.degree(x) > 0])
        assert order == list(AG.nodes())
        ref = nx.community.greedy_modularity_communities(AG, "matches", resolution=1)
        got = tg.greedy_modularity_communities(G, order, "matches")
        assert [set(c) for c in got] == [set(c) for c in ref], seed
        T = tg.maximum_spanning_tree(G, order, "matches")
        assert [(u, v) for u, v, _ in T.edges()] == list(
            nx.maximum_spanning_tree(AG, "matches").edges()), seed
        assert list(tg.clustering(G, order, "matches").items()) == list(
            nx.clustering(AG, weight="matches").items()), seed
