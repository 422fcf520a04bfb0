"""Graph packing: several small graphs in each node row.

One-graph-a-row collation pads every row to the largest graph: ZINC's
molecules average ~23 nodes, so a row padded to 48 is about half padding.
`pack_graphs` instead places the graphs first-fit-decreasing into rows of
`row_len` nodes (~5 ZINC graphs a 128-node row), so each feature product
runs on fewer, fuller rows. Every pairwise quantity (attention, the
Laplacian, the PE kernel) becomes block-diagonal under the `graph_id` pair
mask (`nn/packed.py`).

The batch is a `GraphBatch` with, besides the usual fields (block-diagonal
`adj` and `pe`):

  graph_id    [B, N] int32 graph slot within the row (-1 on padding)
  graph_mask  [B, G] bool, the valid graph slots
  y           [B, G, ...] per-graph labels in slot order
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import Graph, GraphBatch


def pack_rows(sizes: Sequence[int], row_len: int = 128) -> List[List[int]]:
    """First-fit-decreasing placement of graphs of `sizes` nodes into rows
    of `row_len`: each row's graph indices in slot order (the largest graph
    first; ties keep their input order). A graph longer than a row
    raises."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    rows: List[List[int]] = []
    row_space: List[int] = []
    for gi in order:
        n = sizes[gi]
        if n > row_len:
            raise ValueError(f"graph with {n} nodes exceeds row_len {row_len}")
        for r, space in enumerate(row_space):
            if space >= n:
                rows[r].append(gi)
                row_space[r] -= n
                break
        else:
            rows.append([gi])
            row_space.append(row_len - n)
    return rows


def pack_graphs(graphs: Sequence[Graph], row_len: int = 128) -> GraphBatch:
    """`graphs` placed by `pack_rows`, then one host pass that writes each
    graph at its row offset. Graph-level labels only."""
    rows = pack_rows([g.num_nodes for g in graphs], row_len)
    bsz = len(rows)
    g_max = max(len(r) for r in rows)
    g0 = graphs[0]
    f32 = np.float32
    int_x = np.issubdtype(g0.x.dtype, np.integer)
    squeeze_x = int_x and g0.x.shape[-1] == 1
    if squeeze_x:
        x = np.zeros((bsz, row_len), np.int32)
    else:
        x = np.zeros((bsz, row_len, g0.x.shape[-1]),
                     np.int32 if int_x else f32)
    node_mask = np.zeros((bsz, row_len), bool)
    graph_id = np.full((bsz, row_len), -1, np.int32)
    graph_mask = np.zeros((bsz, g_max), bool)
    adj = np.zeros((bsz, row_len, row_len), f32)
    use_pe = g0.pe is not None
    use_lap = g0.lap_pe is not None
    use_deg = g0.degree is not None
    pe = np.zeros((bsz, row_len, row_len), f32) if use_pe else None
    lap_pe = (np.zeros((bsz, row_len, g0.lap_pe.shape[-1]), f32)
              if use_lap else None)
    degree = np.zeros((bsz, row_len), f32) if use_deg else None

    y = None
    if g0.y is not None:
        y0 = np.asarray(g0.y)
        if y0.ndim >= 1 and y0.shape[0] == g0.num_nodes and y0.shape[0] > 1:
            raise NotImplementedError(
                "pack_graphs takes graph-level labels only; node-level "
                "tasks (SBM) take collate_graphs")
        y = np.zeros((bsz, g_max) + y0.shape, y0.dtype)

    for r, members in enumerate(rows):
        off = 0
        for slot, gi in enumerate(members):
            g = graphs[gi]
            n = g.num_nodes
            sl = slice(off, off + n)
            x[r, sl] = g.x.reshape(n) if squeeze_x else g.x
            node_mask[r, sl] = True
            graph_id[r, sl] = slot
            graph_mask[r, slot] = True
            if g.num_edges:
                adj[r, g.edge_index[0] + off, g.edge_index[1] + off] = 1.0
            if use_pe:
                pe[r, sl, sl] = g.pe
            if use_lap:
                lap_pe[r, sl, : g.lap_pe.shape[-1]] = g.lap_pe
            if use_deg:
                degree[r, sl] = g.degree
            if y is not None:
                y[r, slot] = np.asarray(g.y)
            off += n

    t = lambda a: None if a is None else torch.from_numpy(a)
    return GraphBatch(x=t(x), node_mask=t(node_mask), adj=t(adj), y=t(y),
                      pe=t(pe), lap_pe=t(lap_pe), degree=t(degree),
                      graph_id=t(graph_id), graph_mask=t(graph_mask))
