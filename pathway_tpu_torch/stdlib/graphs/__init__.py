"""``pw.graphs`` — graph algorithms over streaming edge tables
(reference ``python/pathway/stdlib/graphs/``: ``graph.py:77,121``,
``bellman_ford/impl.py``, ``pagerank/impl.py``,
``louvain_communities/impl.py``).  All incremental via ``pw.iterate``."""

from __future__ import annotations

import dataclasses
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table

__all__ = [
    "Graph",
    "WeightedGraph",
    "bellman_ford",
    "pagerank",
    "louvain_level",
    "louvain_communities",
    "exact_modularity",
]


@dataclasses.dataclass
class Graph:
    """Edges table with columns u, v (reference ``graphs/graph.py:77``)."""

    edges: Table

    def without_self_loops(self) -> "Graph":
        return Graph(self.edges.filter(pw.this.u != pw.this.v))


@dataclasses.dataclass
class WeightedGraph(Graph):
    """Edges carry a ``weight`` column (reference ``graph.py:121``)."""

    @classmethod
    def from_edges(cls, edges: Table, weight: Any = None) -> "WeightedGraph":
        if weight is not None and getattr(weight, "_name", "weight") != "weight":
            edges = edges.select(u=pw.this.u, v=pw.this.v, weight=weight)
        return cls(edges)


def bellman_ford(vertices: Table, edges: Table) -> Table:
    """Single-source shortest paths (reference
    ``graphs/bellman_ford/impl.py``): ``vertices`` has a ``dist`` column
    (0 for sources, None/inf otherwise); ``edges`` has u, v, dist."""
    import math

    INF = math.inf

    start = vertices.select(
        dist=pw.apply(lambda d: INF if d is None else float(d), pw.this.dist)
    )

    def body(state: Table, edges: Table) -> Table:
        # candidate distances: via each incoming edge
        relaxed = edges.join(state, pw.left.u == pw.right.id).select(
            v=pw.left.v,
            cand=pw.apply(
                lambda du, w: du + float(w), pw.right.dist, pw.left.dist
            ),
        )
        best = relaxed.groupby(relaxed.v, id=relaxed.v).reduce(
            cand=pw.reducers.min(relaxed.cand)
        )
        improved = state.join_left(
            best, pw.left.id == pw.right.id, id=pw.left.id
        ).select(
            dist=pw.apply(
                lambda d, c: d if c is None else min(d, c),
                pw.left.dist,
                pw.right.cand,
            ),
        )
        return improved

    # join on vertex ids: state is keyed by vertex key; edges are
    # read-only context inside the fixpoint
    return pw.iterate(body, state=start, edges=edges)


def pagerank(edges: Table, steps: int = 5, damping: float = 0.85) -> Table:
    """PageRank over an edge table u->v (reference
    ``graphs/pagerank/impl.py``; integer arithmetic there, floats here)."""
    vertices = (
        edges.select(w=pw.this.u)
        .concat_reindex(edges.select(w=pw.this.v))
        .groupby(pw.this.w)
        .reduce(w=pw.this.w)
    )
    degrees = edges.groupby(edges.u).reduce(u=edges.u, deg=pw.reducers.count())
    ranks = vertices.select(w=pw.this.w, rank=pw.apply(lambda _w: 1.0, pw.this.w))

    for _ in range(steps):
        contrib = (
            edges.join(ranks, pw.left.u == pw.right.w)
            .select(v=pw.left.v, part=pw.right.rank, u=pw.left.u)
            .join(degrees, pw.left.u == pw.right.u)
            .select(
                v=pw.left.v,
                part=pw.apply(lambda r, d: r / d, pw.left.part, pw.right.deg),
            )
        )
        summed = contrib.groupby(contrib.v).reduce(
            v=contrib.v, total=pw.reducers.sum(contrib.part)
        )
        ranks = vertices.join_left(
            summed, pw.left.w == pw.right.v, id=pw.left.id
        ).select(
            w=pw.left.w,
            rank=pw.apply(
                lambda t, d=damping: (1 - d) + d * (t or 0.0), pw.right.total
            ),
        )
    return ranks


def louvain_level(
    G: WeightedGraph, iterations: int = 10, total_weight: Table | None = None
) -> Table:
    """One level of Louvain community detection (reference
    ``louvain_communities/impl.py`` ``_louvain_level``, redesigned as a
    host greedy pass over the epoch's aggregated edge set): returns a
    table keyed by vertex with a ``community`` column.

    ``total_weight``: optional 1-row (lower, value, upper) approximation
    table; when given, each vertex's objective uses an ``apx_value``
    delivered via :meth:`Table._gradual_broadcast` — the reference's
    churn-damping route for the global edge-weight sum."""
    edges = G.edges
    vertices = (
        edges.select(w=pw.this.u)
        .concat_reindex(edges.select(w=pw.this.v))
        .groupby(pw.this.w, id=pw.this.w)
        .reduce(w=pw.this.w)
    )
    comm0 = vertices.select(node=pw.this.w, community=pw.this.w)
    if total_weight is not None:
        comm0 = comm0._gradual_broadcast(
            total_weight,
            total_weight.lower,
            total_weight.value,
            total_weight.upper,
        )

    # host-side greedy modularity pass over the (small) aggregated edge set
    packed_edges = edges.reduce(
        all_edges=pw.reducers.tuple(
            pw.apply(lambda u, v, w: (u, v, float(w)), pw.this.u, pw.this.v, pw.this.weight)
        )
    )

    def assign(node, all_edges, apx_total=None):
        import collections

        adj: dict = collections.defaultdict(dict)
        total_w = 0.0
        for u, v, w in all_edges or ():
            adj[u][v] = adj[u].get(v, 0.0) + w
            adj[v][u] = adj[v].get(u, 0.0) + w
            total_w += w
        if apx_total is not None:
            # the gradually-broadcast approximation (within the triplet's
            # [lower, upper] of the true sum) replaces the exact total
            total_w = float(apx_total)
        if total_w == 0:
            return node
        comm = {n: n for n in adj}
        deg = {n: sum(adj[n].values()) for n in adj}
        for _ in range(iterations):
            moved = False
            for n in sorted(adj, key=str):
                best, best_gain = comm[n], 0.0
                neigh_comms: dict = collections.defaultdict(float)
                for m, w in adj[n].items():
                    if m != n:
                        neigh_comms[comm[m]] += w
                sigma = collections.defaultdict(float)
                for m in adj:
                    if m != n:
                        sigma[comm[m]] += deg[m]
                for c, w_in in sorted(neigh_comms.items(), key=lambda kv: str(kv[0])):
                    gain = w_in / total_w - deg[n] * sigma[c] / (2 * total_w**2)
                    if gain > best_gain:
                        best, best_gain = c, gain
                if best != comm[n]:
                    comm[n] = best
                    moved = True
            if not moved:
                break
        return comm.get(node, node)

    if total_weight is not None:
        joined = comm0.join_left(packed_edges, id=pw.left.id).select(
            node=pw.left.node,
            community=pw.apply(
                assign, pw.left.node, pw.right.all_edges, pw.left.apx_value
            ),
        )
    else:
        joined = comm0.join_left(packed_edges, id=pw.left.id).select(
            node=pw.left.node,
            community=pw.apply(assign, pw.left.node, pw.right.all_edges),
        )
    return joined


def _approximate_total_weight(edges: Table, epsilon: float = 0.1) -> Table:
    """1-row (lower, value, upper) window around the total edge weight
    (reference ``_approximate_total_weight``,
    ``louvain_communities/impl.py:263-280``): bounds move only when the
    sum crosses a power of (1+epsilon), so the gradual broadcast barely
    churns as edges stream in."""
    import math

    exact = edges.reduce(m=pw.reducers.sum(pw.this.weight))

    def _floor_pow(x):
        x = max(float(x), 1e-12)
        return (1 + epsilon) ** math.floor(math.log(x, 1 + epsilon))

    def _ceil_pow(x):
        x = max(float(x), 1e-12)
        return (1 + epsilon) ** (math.floor(math.log(x, 1 + epsilon)) + 1)

    return exact.select(
        lower=pw.apply(_floor_pow, pw.this.m),
        value=pw.apply(float, pw.this.m),
        upper=pw.apply(_ceil_pow, pw.this.m),
    )


class louvain_communities:
    """Multi-level Louvain (reference
    ``louvain_communities_fixed_iterations``,
    ``louvain_communities/impl.py:283-338``): repeatedly find one level's
    clustering, contract the graph to cluster vertices (summing parallel
    edge weights), and recurse, with the global total weight delivered to
    every level through :meth:`Table._gradual_broadcast`.

    Attributes (same shape as the reference):

    - ``hierarchical_clustering`` — rows (node, c, level): each vertex or
      intermediate cluster points at its parent cluster one level up.
    - ``clustering_levels`` — rows (v, c, level): every original vertex's
      ancestor at EVERY level (level 0 = itself).
    """

    def __init__(self, G: WeightedGraph, levels: int = 2, apx: float = 0.1):
        total_weight = _approximate_total_weight(G.edges, apx)
        edges = G.edges
        base_vertices = (
            edges.select(w=pw.this.u)
            .concat_reindex(edges.select(w=pw.this.v))
            .groupby(pw.this.w, id=pw.this.w)
            .reduce(w=pw.this.w)
        )
        self.levels = levels
        self.hierarchical_clustering = base_vertices.select(
            node=pw.this.w, c=pw.this.w, level=0
        )
        self.clustering_levels = base_vertices.select(
            v=pw.this.w, c=pw.this.w, level=0
        )
        for lvl in range(levels):
            clustering = louvain_level(
                WeightedGraph(edges), total_weight=total_weight
            )
            self.hierarchical_clustering = self.hierarchical_clustering.concat_reindex(
                clustering.select(
                    node=pw.this.node, c=pw.this.community, level=lvl + 1
                )
            )
            prev = self.clustering_levels.filter(pw.this.level == lvl)
            lifted = prev.join(
                clustering, pw.left.c == pw.right.node
            ).select(v=pw.left.v, c=pw.right.community, level=lvl + 1)
            self.clustering_levels = self.clustering_levels.concat_reindex(lifted)
            # contract: map both endpoints to their communities, merge
            # parallel edges (reference contracted_to_weighted_simple_graph)
            mapped = edges.join(
                clustering, pw.left.u == pw.right.node
            ).select(cu=pw.right.community, v=pw.left.v, weight=pw.left.weight)
            mapped = mapped.join(
                clustering, pw.left.v == pw.right.node
            ).select(u=pw.left.cu, v=pw.right.community, weight=pw.left.weight)
            edges = mapped.groupby(pw.this.u, pw.this.v).reduce(
                pw.this.u, pw.this.v, weight=pw.reducers.sum(pw.this.weight)
            )
        self.final_clustering = self.clustering_levels.filter(
            pw.this.level == levels
        )


def exact_modularity(G: WeightedGraph, C: Table, round_digits: int = 16) -> Table:
    """Modularity of clustering ``C`` (rows: v -> c) over ``G`` — test and
    development helper (reference ``exact_modularity``,
    ``louvain_communities/impl.py:340-385``)."""
    packed_edges = G.edges.reduce(
        es=pw.reducers.tuple(
            pw.apply(
                lambda u, v, w: (u, v, float(w)),
                pw.this.u,
                pw.this.v,
                pw.this.weight,
            )
        )
    )
    packed_c = C.reduce(
        cs=pw.reducers.tuple(pw.apply(lambda v, c: (v, c), pw.this.v, pw.this.c))
    )

    def modularity(es, cs):
        comm = dict(cs or ())
        m = sum(w for _u, _v, w in es or ())
        if m == 0:
            return 0.0
        intra = {}
        deg = {}
        for u, v, w in es:
            deg[u] = deg.get(u, 0.0) + w
            deg[v] = deg.get(v, 0.0) + w
            cu = comm.get(u)
            # endpoints missing from C (e.g. clustering from an earlier
            # epoch's vertex set) contribute degree but no intra weight
            if cu is not None and cu == comm.get(v):
                intra[cu] = intra.get(cu, 0.0) + w
        q = 0.0
        communities = set(comm.values())
        for c in communities:
            tot = sum(d for n, d in deg.items() if comm.get(n) == c)
            q += intra.get(c, 0.0) / m - (tot / (2 * m)) ** 2
        return round(q, round_digits)

    return packed_edges.join(packed_c, id=pw.left.id).select(
        modularity=pw.apply(modularity, pw.left.es, pw.right.cs)
    )
