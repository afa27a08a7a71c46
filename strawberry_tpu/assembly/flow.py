"""Constrained Minimum Path Cover via min-cost flow with lower bounds.

Host oracle for FlowNetwork::{createNetwork,addWeight,findConstraints,
solveNetwork,flowDecompose} (ref: src/assembly.cpp:549-998), reproducing
lemon ListDigraph's *iteration order* (nodes and out-arcs iterate
newest-first, lemon list_graph.h:112-144,182-218) because the greedy flow
decomposition breaks cost ties by iteration order.

The golden flow solve itself is the lemon-exact NetworkSimplex
(assembly/lemonns.py oracle; native/lemonns.cc on the hot path, where it
is chained with the decompose/reconstruct below inside assembleprep.cc).
min_cost_flow here delegates to the dense SSP spec
(assembly/mincostflow.py) — the formulation the batched device DP
(assembly/device.py, Bellman-Ford relaxations as masked min-plus matrix
ops over padded adjacency tensors) is validated against; on degenerate
optima it may pick a different optimal flow than lemon, which is why it is
opt-in (STRAWB_DEVICE_MCF).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..config import Config
from ..core.features import (Contig, Feature, S_INTRON, S_MATCH, feat_right,
                             merge_features)
from .coverage import IntronMap
from .splice_graph import ExonSeg

INT_MAX = 2 ** 31 - 1


class Graph:
    """ListDigraph clone: prepend-ordered node and arc iteration."""

    def __init__(self):
        self.arc_src: List[int] = []
        self.arc_dst: List[int] = []
        self._out: List[List[int]] = []   # per node, arcs in insertion order
        self._in: List[List[int]] = []
        self.n_nodes = 0

    def add_node(self) -> int:
        self._out.append([])
        self._in.append([])
        self.n_nodes += 1
        return self.n_nodes - 1

    def add_arc(self, u: int, v: int) -> int:
        a = len(self.arc_src)
        self.arc_src.append(u)
        self.arc_dst.append(v)
        self._out[u].append(a)
        self._in[v].append(a)
        return a

    def nodes_it(self):
        """NodeIt: newest node first."""
        return range(self.n_nodes - 1, -1, -1)

    def out_arcs(self, u: int):
        """OutArcIt: newest arc first."""
        return reversed(self._out[u])

    def in_arcs(self, v: int):
        return reversed(self._in[v])

    def out_deg(self, u: int) -> int:
        return len(self._out[u])

    def in_deg(self, v: int) -> int:
        return len(self._in[v])

    def find_arc(self, u: int, v: int) -> int:
        for a in self.out_arcs(u):
            if self.arc_dst[a] == v:
                return a
        return -1

    def n_arcs(self) -> int:
        return len(self.arc_src)

    def bfs_path(self, src: int, dst: int) -> Optional[List[int]]:
        """lemon Bfs: FIFO queue, neighbors in OutArcIt order; returns the
        node path src..dst via the BFS predecessor tree, or None."""
        pred = {src: -1}
        queue = [src]
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            for a in self.out_arcs(u):
                w = self.arc_dst[a]
                if w not in pred:
                    pred[w] = u
                    queue.append(w)
        if dst not in pred:
            return None
        path = [dst]
        p = pred[dst]
        while p != -1:
            path.append(p)
            p = pred[p]
        path.reverse()
        return path


class FlowNetwork:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.g = Graph()
        self.max_weight = 0.0
        self.source = -1
        self.sink = -1

    # ------------------------------------------------------------------
    def create_network(self, hits: List[Contig], exons: List[ExonSeg],
                       intron_counter: IntronMap,
                       node2exon: Dict[int, int],
                       cost_map: Dict[int, int],
                       min_flow_map: Dict[int, int],
                       path_cstrs: List[List[int]],
                       hit_flat=None, weight_mass=None) -> bool:
        """createNetwork (assembly.cpp:549-765)."""
        g = self.g
        assert hits or (hit_flat is not None and len(hit_flat[0]) > 1)
        if len(exons) == 1:
            return True
        nodes = []
        for i in range(len(exons)):
            n = g.add_node()
            node2exon[n] = i
            nodes.append(n)
        if not exons or not intron_counter:
            return False

        arcs: List[int] = []
        exon_rights = [e.right for e in exons]
        exon_lefts = [e.left for e in exons]
        from bisect import bisect_left
        # 1) intron arcs, in sorted intron order
        for (il, ir) in sorted(intron_counter.keys()):
            e1 = bisect_left(exon_rights, il - 1)
            e2 = bisect_left(exon_lefts, ir + 1)
            if e1 == len(exons) or e2 == len(exons):
                continue  # reference: DEBUG assert, silently tolerated
            arcs.append(g.add_arc(nodes[e1], nodes[e2]))
        # 2) adjacency arcs
        for i in range(len(exons) - 1):
            if exons[i + 1].left == exons[i].right + 1:
                arcs.append(g.add_arc(nodes[i], nodes[i + 1]))

        self.add_weight(hits, intron_counter, node2exon, exons, cost_map,
                        hit_flat=hit_flat, weight_mass=weight_mass)

        # subpath constraints (assembly.cpp:616-699)
        constraints = self.find_constraints(exons, hits, hit_flat=hit_flat)
        for c in constraints:
            path_cstr: List[int] = []
            s = nodes[c[0]]
            t = nodes[c[-1]]
            is_valid = False
            for idx in range(1, len(c) - 1):
                n = nodes[c[idx]]
                if g.in_deg(n) > 1 and g.out_deg(n) > 1:
                    is_valid = True
            if g.find_arc(s, t) == -1 and is_valid:
                for i in range(len(c) - 1):
                    pre = nodes[c[i]]
                    sec = nodes[c[i + 1]]
                    arc_found = g.find_arc(pre, sec)
                    if arc_found == -1:
                        path = g.bfs_path(pre, sec)
                        if path is not None:
                            assert len(path) > 2
                            for jj in range(len(path) - 1):
                                a = g.find_arc(path[jj], path[jj + 1])
                                if a != -1:
                                    path_cstr.append(a)
                    else:
                        path_cstr.append(arc_found)
                if path_cstr:
                    path_cstrs.append(path_cstr)

        if not path_cstrs:
            for a in arcs:
                min_flow_map[a] = 1
            return True

        one_d: Set[int] = set()
        for p in path_cstrs:
            one_d.update(p)
        for a in arcs:
            if a not in one_d:
                path_cstrs.append([a])

        for p in path_cstrs:
            assert p
            if len(p) > 1:
                cost = sum(cost_map[a] for a in p)
                s = g.arc_src[p[0]]
                t = g.arc_dst[p[-1]]
                if g.find_arc(s, t) == -1:
                    a = g.add_arc(s, t)
                    cost_map[a] = cost
                    min_flow_map[a] = 1
            else:
                min_flow_map[p[0]] = 1
        return True

    # ------------------------------------------------------------------
    def add_weight(self, hits: List[Contig], intron_counter: IntronMap,
                   node2exon: Dict[int, int], exons: List[ExonSeg],
                   cost_map: Dict[int, int], hit_flat=None,
                   weight_mass=None) -> None:
        """addWeight (assembly.cpp:767-811). Arc cost = trunc(max_support -
        trunc(arc_support)); supports from junction reads (intron arcs) or
        spanning reads with >=kMinDist4ExonEdge overhang (adjacency arcs).
        With hit_flat/weight_mass the order-sensitive adjacency scan runs
        in C++ (strawb_adj_support)."""
        g = self.g
        cfg = self.cfg
        sorted_introns = sorted(intron_counter.items())
        supports: Dict[int, float] = {}
        adj_arcs: List[int] = []
        adj_s: List[int] = []
        adj_e: List[int] = []
        # ArcIt order: nodes newest-first, each node's out-arcs newest-first
        for u in g.nodes_it():
            for arc in g.out_arcs(u):
                s_exon = exons[node2exon[g.arc_src[arc]]]
                t_exon = exons[node2exon[g.arc_dst[arc]]]
                arc_s = s_exon.right
                arc_e = t_exon.left
                support = 0.0
                if arc_e - arc_s == 1:
                    if hit_flat is not None:
                        adj_arcs.append(arc)
                        adj_s.append(arc_s)
                        adj_e.append(arc_e)
                        supports[arc] = 0.0
                        continue
                    for mp in hits:
                        if mp.left > arc_e:
                            break
                        if mp.right < arc_s:
                            continue
                        for f in mp.feats:
                            if f[0] == S_MATCH:
                                if (f[1] <= arc_s - cfg.min_dist_4_exon_edge
                                        and feat_right(f) >=
                                        arc_e + cfg.min_dist_4_exon_edge):
                                    support += mp.mass
                else:
                    il = arc_s + 1
                    ir = arc_e - 1
                    for (kl, kr), ent in sorted_introns:
                        if il == kl and ir == kr:
                            support = (ent.total_junc_reads
                                       * cfg.intron_edge_weight)
                            break
                self.max_weight = max(self.max_weight, support)
                supports[arc] = support
        if adj_arcs:
            from ..core.fastcluster import native_adj_support
            sup = native_adj_support(hit_flat, weight_mass, adj_s, adj_e,
                                     cfg.min_dist_4_exon_edge)
            for arc, sv in zip(adj_arcs, sup):
                supports[arc] = float(sv)
                self.max_weight = max(self.max_weight, float(sv))
        for arc in supports:
            cost_map[arc] = int(self.max_weight - int(supports[arc]))

    # ------------------------------------------------------------------
    def find_constraints(self, exons: List[ExonSeg],
                         hits: List[Contig],
                         hit_flat=None) -> List[List[int]]:
        """findConstraints (assembly.cpp:856-879): per-hit overlapped exon
        index sets of size > 2, sorted + unique."""
        if hit_flat is not None and len(hit_flat[0]) > 1:
            from ..core.fastcluster import native_constraints
            return native_constraints([e.feature for e in exons], hit_flat)
        result: List[Tuple[int, ...]] = []
        for mp in hits:
            idxs: Set[int] = set()
            for i, ex in enumerate(exons):
                for f in mp.feats:
                    if f[0] != S_MATCH:
                        continue
                    if f[1] <= ex.right and ex.left <= feat_right(f):
                        idxs.add(i)
            c = tuple(sorted(idxs))
            if len(c) > 2:
                result.append(c)
        uniq = sorted(set(result))
        return [list(c) for c in uniq]

    # ------------------------------------------------------------------
    def add_sink_source(self) -> None:
        """add_sink_source (assembly.cpp:91-112): source/sink nodes, arcs to
        in-degree-0 / from out-degree-0 nodes (NodeIt order), plus the
        circulation arc sink->source."""
        g = self.g
        self.source = g.add_node()
        self.sink = g.add_node()
        for n in g.nodes_it():
            if n == self.source or n == self.sink:
                continue
            if g.in_deg(n) == 0:
                g.add_arc(self.source, n)
            if g.out_deg(n) == 0:
                g.add_arc(n, self.sink)
        g.add_arc(self.sink, self.source)

    # ------------------------------------------------------------------
    def dense_problem(self, cost_map: Dict[int, int],
                      min_flow_map: Dict[int, int]):
        """Dense (M,M) matrices for the pair-unique flow graph."""
        import numpy as np
        g = self.g
        M = g.n_nodes
        cost = np.zeros((M, M), dtype=np.int64)
        has_arc = np.zeros((M, M), dtype=bool)
        lower = np.zeros((M, M), dtype=np.int64)
        for a in range(g.n_arcs()):
            u, v = g.arc_src[a], g.arc_dst[a]
            has_arc[u, v] = True
            cost[u, v] = cost_map.get(a, 0)
            lower[u, v] = min_flow_map.get(a, 0)
        return cost, has_arc, lower

    def min_cost_flow(self, cost_map: Dict[int, int],
                      min_flow_map: Dict[int, int]
                      ) -> Optional[Dict[int, int]]:
        """Min-cost circulation with lower bounds, upper = INF.

        Delegates to the dense synchronous-Bellman-Ford SSP spec shared
        with the batched device kernel (assembly/mincostflow.py). Same
        optimum as the reference's NetworkSimplex run (assembly.cpp:
        896-904) whenever the optimum is unique; tie cases are validated
        against golden outputs. Returns arc -> flow, or None if infeasible.
        """
        from .mincostflow import solve_dense
        g = self.g
        cost, has_arc, lower = self.dense_problem(cost_map, min_flow_map)
        fm = solve_dense(cost, has_arc, lower)
        if fm is None:
            return None
        return {a: int(fm[g.arc_src[a], g.arc_dst[a]])
                for a in range(g.n_arcs())}

    # ------------------------------------------------------------------
    def flow_decompose(self, flow: Dict[int, int],
                       cost_map: Dict[int, int]) -> List[List[int]]:
        """flowDecompose (assembly.cpp:116-172): greedily walk cheapest
        flow-carrying out-arcs source->sink, decrementing one unit per path.
        Source out-arcs inherit the min cost of their target's out-arcs."""
        g = self.g
        copy_flow = dict(flow)
        edge_cost = {a: cost_map.get(a, 0) for a in range(g.n_arcs())}
        for out in g.out_arcs(self.source):
            opt = INT_MAX
            cur = g.arc_dst[out]
            for out2 in g.out_arcs(cur):
                opt = min(opt, cost_map.get(out2, 0))
            edge_cost[out] = opt

        paths: List[List[int]] = []
        while any(copy_flow.get(a, 0) > 0 for a in g.out_arcs(self.source)):
            path: List[int] = []
            cur = self.source
            while cur != self.sink:
                opt_arc = -1
                opt_cost = INT_MAX
                for out in g.out_arcs(cur):
                    if copy_flow.get(out, 0) > 0:
                        if edge_cost[out] < opt_cost:
                            opt_cost = edge_cost[out]
                            opt_arc = out
                if opt_arc == -1:
                    # dead end: mirrors reference UB-free assumption; bail
                    return paths
                cur = g.arc_dst[opt_arc]
                path.append(opt_arc)
            for a in path:
                copy_flow[a] -= 1
            paths.append(path)
        return paths

    # ------------------------------------------------------------------
    def solve_network(self, node2exon: Dict[int, int], exons: List[ExonSeg],
                      path_cstrs: List[List[int]],
                      cost_map: Dict[int, int],
                      min_flow_map: Dict[int, int]
                      ) -> Optional[List[List[Feature]]]:
        """solveNetwork (assembly.cpp:882-980), host flow solve."""
        self.add_sink_source()
        flow = self.min_cost_flow(cost_map, min_flow_map)
        if flow is None:
            return None
        return self.reconstruct(node2exon, exons, path_cstrs, cost_map, flow)

    def reconstruct(self, node2exon: Dict[int, int], exons: List[ExonSeg],
                    path_cstrs: List[List[int]],
                    cost_map: Dict[int, int],
                    flow: Dict[int, int]
                    ) -> Optional[List[List[Feature]]]:
        """Greedy decomposition + transcript rebuild from a solved flow
        (tail of solveNetwork, assembly.cpp:925-980)."""
        g = self.g
        cfg = self.cfg
        transcripts: List[List[Feature]] = []
        if len(exons) == 1:
            transcripts.append([exons[0].feature])

        paths = self.flow_decompose(flow, cost_map)

        exon_feat = {n: exons[i].feature for n, i in node2exon.items()}
        for p in paths:
            tscp: List[Feature] = []
            for i in range(1, len(p)):
                e = p[i]
                arc_s = g.arc_src[e]
                arc_t = g.arc_dst[e]
                is_edge = True
                for cstr in path_cstrs:
                    ps = g.arc_src[cstr[0]]
                    pt = g.arc_dst[cstr[-1]]
                    if arc_s == ps and arc_t == pt:
                        is_edge = False
                        for idx in range(len(cstr) - 1):
                            n1 = g.arc_src[cstr[idx]]
                            n2 = g.arc_src[cstr[idx + 1]]
                            f1 = exon_feat[n1]
                            f2 = exon_feat[n2]
                            tscp.append(f1)
                            if f2[1] - feat_right(f1) > 1:
                                tscp.append((S_INTRON, feat_right(f1) + 1,
                                             f2[1] - 1 - feat_right(f1)))
                        n1 = g.arc_src[cstr[-1]]
                        n2 = g.arc_dst[cstr[-1]]
                        f1 = exon_feat[n1]
                        f2 = exon_feat[n2]
                        tscp.append(f1)
                        if f2[1] - feat_right(f1) > 1:
                            tscp.append((S_INTRON, feat_right(f1) + 1,
                                         f2[1] - 1 - feat_right(f1)))
                        break
                if is_edge:
                    f1 = exon_feat[arc_s]
                    tscp.append(f1)
                    if i + 1 < len(p):
                        f2 = exon_feat[arc_t]
                        if f2[1] - feat_right(f1) > 1:
                            tscp.append((S_INTRON, feat_right(f1) + 1,
                                         f2[1] - 1 - feat_right(f1)))
            transcripts.append(tscp)

        # filter_short_transcripts (assembly.cpp:982-998)
        transcripts = [
            t for t in transcripts
            if sum(f[2] for f in t if f[0] == S_MATCH) >= cfg.min_trans_len
        ]
        if not transcripts:
            return None
        return transcripts


def assemble_2_contigs(assembled_feats: List[List[Feature]],
                       exons: List[ExonSeg], ref_id: int,
                       strand: int, cfg: Config) -> List[Contig]:
    """assemble_2_contigs (include/assembly.h:106-124): merge features,
    depth-filter (avg over merged MATCH features, each carrying the avg_doc
    of its first constituent exon seg), dedupe, sort."""
    doc_by_left = {e.left: e.avg_doc for e in exons}
    results: List[Contig] = []
    for feats in assembled_feats:
        merged = merge_features(feats)
        covs = [doc_by_left.get(f[1], 0.0) for f in merged if f[0] == S_MATCH]
        ct = Contig(ref_id=ref_id, strand=strand, feats=merged, mass=1.0,
                    is_ref=True, contig_id=0)
        ct.avg_covs = covs
        if ct.avg_doc() < cfg.min_depth_4_contig:
            continue
        results.append(ct)
    results.sort(key=lambda c: c.sort_key())
    out: List[Contig] = []
    for c in results:
        if out and (out[-1].ref_id == c.ref_id
                    and out[-1].feats == c.feats):
            continue
        out.append(c)
    return out
