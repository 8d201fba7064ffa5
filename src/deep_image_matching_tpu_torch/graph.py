"""View-graph analysis of the matching database (port of
``deep_image_matching_tpu/graph.py``), without networkx.

Nodes are the database's images, edges its verified pairs weighted by their
match count. ``view_graph`` writes, as the JAX package does on networkx 3.x,
``communities.csv`` (greedy modularity communities, Clauset-Newman-Moore),
``mst_pairs.txt`` (maximum spanning tree, Kruskal),
``mst_expanded_pairs.txt`` (the tree plus the edges between communities)
and ``graph.html`` (a vis-network page; nodes coloured by community, grey
for clustering-coefficient outliers). The three algorithms are written here
over the same dict-of-dicts adjacency, in networkx's orders, so the files
are equal byte for byte: the subgraph of linked images iterates its nodes
as networkx's node filter does (the filter's own set where it holds fewer
than half the nodes), modularity merges the pair of communities with the
largest gain (ties: the smallest (row, column)) into the second, the
communities sort by size with ties in node order, Kruskal's sort keeps the
edge order among equal weights, and the weighted clustering sums in
networkx's set orders.
"""

from __future__ import annotations

import heapq
import logging
import sqlite3
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from .io.colmap_db import pair_id_to_image_ids

logger = logging.getLogger("dim_tpu_torch")

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<script src="https://unpkg.com/vis-network/standalone/umd/vis-network.min.js"></script>
<style>#net {{ width: 100%; height: 95vh; border: 1px solid #ccc; }}</style>
</head><body><div id="net"></div>
<script>
var nodes = new vis.DataSet({nodes});
var edges = new vis.DataSet({edges});
new vis.Network(document.getElementById("net"), {{nodes: nodes, edges: edges}},
  {{physics: {{solver: "forceAtlas2Based"}}}});
</script></body></html>
"""

_PALETTE = [
    "#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4",
    "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080",
]


class Graph:
    """An undirected graph as networkx stores one: ``nodes`` maps a node to
    its attributes and ``adj`` a node to {neighbour: edge attributes}, both
    in insertion order, one attribute dict shared by an edge's two ends."""

    def __init__(self):
        self.nodes: Dict[int, dict] = {}
        self.adj: Dict[int, Dict[int, dict]] = {}

    def add_node(self, n: int, **attr) -> None:
        if n not in self.nodes:
            self.adj[n] = {}
            self.nodes[n] = {}
        self.nodes[n].update(attr)

    def add_edge(self, u: int, v: int, **attr) -> None:
        self.add_node(u)
        self.add_node(v)
        d = self.adj[u].get(v, {})
        d.update(attr)
        self.adj[u][v] = d
        self.adj[v][u] = d

    def edges(self, order=None):
        """(u, v, data) once per edge: nodes in ``order`` (default: insertion
        order), each node's neighbours in insertion order, skipping
        neighbours already visited."""
        seen = set()
        for n in self.nodes if order is None else order:
            for nbr, d in self.adj[n].items():
                if nbr not in seen:
                    yield n, nbr, d
            seen.add(n)

    def degree(self, n: int) -> int:
        return len(self.adj[n]) + (1 if n in self.adj[n] else 0)


def build_graph_from_db(db_path: Union[str, Path]) -> Graph:
    con = sqlite3.connect(str(db_path))
    cur = con.cursor()
    G = Graph()
    for name, img_id in cur.execute("SELECT name, image_id FROM images"):
        G.add_node(int(img_id), title=str(name))
    for pair_id, rows in cur.execute("SELECT pair_id, rows FROM two_view_geometries"):
        i, j = pair_id_to_image_ids(pair_id)
        G.add_edge(int(i), int(j), matches=int(rows))
    con.close()
    return G


def subgraph_order(G: Graph, nodes: List[int]) -> List[int]:
    """The node order of networkx's ``G.subgraph(nodes)``: its filter keeps
    ``set(nodes)``, and iterates that set where it is under half of G's
    nodes, else G's nodes in order."""
    keep = set(n for n in nodes if n in G.nodes)
    if 2 * len(keep) < len(G.nodes):
        return [n for n in keep if n in G.nodes]
    return [n for n in G.nodes if n in keep]


def greedy_modularity_communities(G: Graph, order: List[int], weight: str,
                                  resolution: float = 1) -> List[frozenset]:
    """Clauset-Newman-Moore greedy modularity on the subgraph of ``order``
    (networkx's ``greedy_modularity_communities(G, weight, resolution)``):
    merge the pair (u, v) with the largest modularity gain, the smallest
    (u, v) among equal gains, u into v, while the gain is not negative;
    the communities by size, largest first, ties in node order."""
    deg = {n: sum(d.get(weight, 1) for d in G.adj[n].values()) for n in order}
    m = sum(deg.values()) / 2
    q0 = 1 / m
    a = {n: deg[n] * q0 * 0.5 for n in order}
    dq: Dict[int, Dict[int, float]] = {n: {} for n in order}
    for u, v, d in G.edges(order):
        if u == v:
            continue
        wt = d.get(weight, 1)
        dq[u][v] = dq[u].get(v, 0.0) + wt
        dq[v][u] = dq[v].get(u, 0.0) + wt
    for u, nbrs in dq.items():
        for v, wt in nbrs.items():
            nbrs[v] = q0 * wt - resolution * (a[u] * a[v] + a[u] * a[v])
    # the largest gain: a heap of (-gain, u, v), stale entries skipped
    heap = [(-g, u, v) for u, nbrs in dq.items() for v, g in nbrs.items()]
    heapq.heapify(heap)
    communities = {n: frozenset([n]) for n in order}
    while heap:
        neg, u, v = heapq.heappop(heap)
        if u not in dq or dq[u].get(v) is None or -dq[u][v] != neg:
            continue
        if -neg < 0:
            break
        communities[v] = frozenset(communities[u] | communities[v])
        del communities[u]
        u_nbrs, v_nbrs = set(dq[u]), set(dq[v])
        for w in (u_nbrs | v_nbrs) - {u, v}:
            if w in u_nbrs and w in v_nbrs:
                g = dq[v][w] + dq[u][w]
            elif w in v_nbrs:
                g = dq[v][w] - resolution * (a[u] * a[w] + a[w] * a[u])
            else:
                g = dq[u][w] - resolution * (a[v] * a[w] + a[w] * a[v])
            dq[v][w] = dq[w][v] = g
            heapq.heappush(heap, (-g, v, w))
            heapq.heappush(heap, (-g, w, v))
        for w in dq[u]:
            del dq[w][u]
        del dq[u]
        a[v] += a[u]
        a[u] = 0
    return sorted(communities.values(), key=len, reverse=True)


def maximum_spanning_tree(G: Graph, order: List[int], weight: str) -> Graph:
    """networkx's ``maximum_spanning_tree(G, weight)`` (Kruskal): edges
    sorted by weight, largest first and stably, each taken where it joins two
    trees; the tree holds the nodes in ``order`` and its edges in the order
    taken."""
    edges = sorted(((d.get(weight, 1), u, v, d) for u, v, d in G.edges(order)),
                   key=lambda e: e[0], reverse=True)
    parent: Dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    T = Graph()
    for n in order:
        T.add_node(n, **G.nodes[n])
    for _, u, v, d in edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            T.add_edge(u, v, **d)
            parent[ru] = rv
    return T


def clustering(G: Graph, order: List[int], weight: str) -> Dict[int, float]:
    """networkx's weighted ``clustering(G, weight=weight)``: geometric means
    of the triangles' normalised edge weights, summed in networkx's set
    orders."""
    max_weight = max(d.get(weight, 1) for _, _, d in G.edges(order))

    def wt(u, v):
        return G.adj[u][v].get(weight, 1) / max_weight

    out = {}
    for i in order:
        # sets filled one key at a time, as from networkx's filtered
        # adjacency views: their iteration orders set the summation order
        inbrs = set(iter(G.adj[i])) - {i}
        weighted_triangles = 0
        seen = set()
        for j in inbrs:
            seen.add(j)
            jnbrs = set(iter(G.adj[j])) - seen
            wij = wt(i, j)
            weighted_triangles += np.cbrt([(wij * wt(j, k) * wt(k, i))
                                           for k in inbrs & jnbrs]).sum()
        d, t = len(inbrs), 2 * float(weighted_triangles)
        out[i] = 0 if t == 0 else t / (d * (d - 1))
    return out


def view_graph(
    db: Union[str, Path],
    output_dir: Union[str, Path],
    imgs_dir: Union[str, Path] = None,
) -> None:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    G = build_graph_from_db(db)
    if not any(G.adj[n] for n in G.nodes):
        logger.warning("View graph has no edges; skipping visualization")
        return

    # analysis subgraph = aligned (non-isolated) nodes
    order = subgraph_order(G, [n for n in G.nodes if G.degree(n) > 0])
    communities = greedy_modularity_communities(G, order, "matches", resolution=1)
    mst = maximum_spanning_tree(G, order, "matches")

    # clustering-coefficient outliers (reference graph.py:214-224)
    clust = clustering(G, order, "matches")
    mean_c = sum(clust.values()) / max(len(clust), 1)
    outliers = {n for n, c in clust.items() if c < 0.3 * mean_c}

    # communities.csv: image name, community index
    comm_of = {}
    for ci, comm in enumerate(communities):
        for n in comm:
            comm_of[n] = ci
    with open(output_dir / "communities.csv", "w") as f:
        f.write("image,community\n")
        for n in sorted(comm_of):
            f.write(f"{G.nodes[n].get('title', n)},{comm_of[n]}\n")

    # MST pair list + expansion edges between communities
    def write_pairs(path, edges):
        with open(path, "w") as f:
            for i, j in edges:
                f.write(f"{G.nodes[i].get('title', i)} {G.nodes[j].get('title', j)}\n")

    mst_edges = [(i, j) for i, j, _ in mst.edges()]
    write_pairs(output_dir / "mst_pairs.txt", mst_edges)
    expansion = [
        (i, j) for i, j, _ in G.edges(order)
        if comm_of.get(i) != comm_of.get(j) and j not in mst.adj[i]
    ]
    write_pairs(output_dir / "mst_expanded_pairs.txt", mst_edges + expansion)

    # interactive HTML
    nodes_js = [
        {
            "id": n,
            "label": str(n),
            "title": G.nodes[n].get("title", str(n)),
            "color": _PALETTE[comm_of.get(n, 0) % len(_PALETTE)]
            if n not in outliers
            else "#808080",
        }
        for n in G.nodes
    ]
    max_m = max(d["matches"] for _, _, d in G.edges())
    edges_js = [
        {"from": i, "to": j, "value": d["matches"] / max_m, "title": f"{d['matches']} matches"}
        for i, j, d in G.edges()
    ]
    (output_dir / "graph.html").write_text(_HTML_TEMPLATE.format(nodes=nodes_js, edges=edges_js))
    logger.info(
        f"View graph: {len(G.nodes)} nodes, {len(edges_js)} edges, "
        f"{len(communities)} communities, {len(outliers)} outlier nodes "
        f"-> {output_dir / 'graph.html'}"
    )
