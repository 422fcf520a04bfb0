"""PNA with LSPE.

Twin of the JAX package's `nn/pna.py` (the rebuild of the LSPE
reference's pna_lspe_layer.py, pna_utils.py and pna_net.py): Principal
Neighbourhood Aggregation towers over pretransformed edge messages, with
the {mean, max, min, std, sum, var} aggregators times the {identity,
amplification, attenuation} degree scalers, a positional channel p, the
towers' mixing layers and the p_out / Whp fusion.

  - A tower's pretransform is one Dense over the edge's concat(h_src,
    h_dst[, e]), split exactly into a node product for the source block,
    one for the destination block, and an edge product (`EdgeDense`), so
    that no [B, N, N, 2d + de] concatenation is built. Messages live as
    the dense [B, N(dst), N(src), d] field masked to real in-edges, or in
    sparse mode (`sparse_edges=True`, a batch collated with `with_coo`)
    as [B, E, d] with one-hot gathers and segment sums and the in-edge
    table for max / min (`ops/sparse_agg.py`).
  - The towers of a layer run as one batched computation: every tower
    parameter is stacked [T, ...] under the scope `towers` (the layout of
    the JAX package's `nn.vmap`), the inputs are split [T, B, N, .] and
    each product is one batched matmul over T, so a layer issues the same
    number of operations for any T. With `vmap_towers=False` the towers
    are separate modules `tower_<t>` run in a loop, as JAX's tower loop.
  - The net's optional GRU (`gru`) runs between layers, shared across
    them (flax GRUCell's parameters ir, iz, in, hr, hz, hn).
  - `average_log_degree` is the training set's mean log(in-degree + 1),
    the scalers' normaliser, which serving must reuse.

Parameters keep the flax names and layouts (`convert.from_flax`; the
tower Dense layers are raw [..., in, out] `kernel` / `bias` leaves).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.nn.layers import MaskedBatchNorm, dense, lecun_normal_
from feta_tmlr_tpu_torch.nn.lspe import LSPENetBase
from feta_tmlr_tpu_torch.nn.san import embedding, hash_dropout
from feta_tmlr_tpu_torch.ops.masking import in_edge_mask
from feta_tmlr_tpu_torch.ops.sparse_agg import (
    SparseEdges,
    edge_ids_from_dense,
    incidence_max,
    incidence_min,
    make_sparse_edges,
)

EPS = 1e-5
SCALERS = ("identity", "amplification", "attenuation")
ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh}


class StackedDense(nn.Module):
    """A Dense layer with raw `kernel` [*lead, in, out] and `bias`
    [*lead, out]; x is [*lead, ..., in], one product per leading index."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator,
                 lead: tuple = ()):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(*lead, d_in, d_out), generator, d_in))
        self.bias = nn.Parameter(torch.zeros(*lead, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stacked_matmul(x, self.kernel) + _per_lead(self.bias, x)


def _per_lead(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t [*lead, k] broadcast against x [*lead, ..., k]."""
    lead = t.dim() - 1
    return t.reshape(t.shape[:lead] + (1,) * (x.dim() - lead - 1)
                     + t.shape[-1:])


def stacked_matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x [*lead, ..., in] @ kernel [*lead, in, out]."""
    lead = kernel.dim() - 2
    return x @ kernel.reshape(kernel.shape[:lead]
                              + (1,) * (x.dim() - lead - 2)
                              + kernel.shape[-2:])


class MLP(nn.Module):
    """`layers` Dense layers (fc_0 .. fc_{layers-2}, fc_out) with `act`
    between them."""

    def __init__(self, d_in: int, hidden: int, out: int, layers: int,
                 act: str, g: torch.Generator, lead: tuple = ()):
        super().__init__()
        self.act, self.layers = ACTIVATIONS[act], layers
        dims = [d_in] + [hidden] * (layers - 1)
        for i in range(layers - 1):
            self.add_module(f"fc_{i}", StackedDense(dims[i], hidden, g, lead))
        self.fc_out = StackedDense(dims[-1], out, g, lead)

    def forward(self, x):
        for i in range(self.layers - 1):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return self.fc_out(x)


class EdgeDense(nn.Module):
    """The first pretransform Dense over the edge's concat(src, dst[, ef]),
    decomposed: kernel [*lead, 2 dx + de, F] rows [:dx] multiply the
    source node, [dx:2dx] the destination, [2dx:] the edge features."""

    def __init__(self, dx: int, de: int, features: int, g: torch.Generator,
                 lead: tuple = ()):
        super().__init__()
        self.dx = dx
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(*lead, 2 * dx + de, features), g, 2 * dx + de))
        self.bias = nn.Parameter(torch.zeros(*lead, features))

    def forward(self, x, ef, edges: Optional[SparseEdges] = None):
        """x [*lead, B, N, dx]; ef [B, N, N, de] (src, dst) in dense mode,
        [B, E, de] in sparse mode, or None. Returns the messages [*lead,
        B, N(dst), N(src), F], or [*lead, B, E, F]."""
        k, dx = self.kernel, self.dx
        src = stacked_matmul(x, k[..., :dx, :])
        dst = stacked_matmul(x, k[..., dx:2 * dx, :])
        if ef is not None:
            # the edge features are shared by the stacked towers
            ef = stacked_matmul(ef.reshape((1,) * (k.dim() - 2) + ef.shape),
                                k[..., 2 * dx:, :])
        if edges is not None:
            out = edges.gather_src(src) + edges.gather_dst(dst)
            if ef is not None:
                out = out + ef
        else:
            out = src.unsqueeze(-3) + dst.unsqueeze(-2)
            if ef is not None:
                out = out + ef.transpose(-3, -2)
        return out + _per_lead(self.bias, out)


class EdgeMLP(nn.Module):
    """Pretransform MLP whose first layer is the decomposed `EdgeDense`
    (named as `MLP`'s layers)."""

    def __init__(self, dx: int, de: int, hidden: int, out: int, layers: int,
                 act: str, g: torch.Generator, lead: tuple = ()):
        super().__init__()
        self.act, self.layers = ACTIVATIONS[act], layers
        if layers == 1:
            self.fc_out = EdgeDense(dx, de, out, g, lead)
            return
        self.fc_0 = EdgeDense(dx, de, hidden, g, lead)
        for i in range(1, layers - 1):
            self.add_module(f"fc_{i}", StackedDense(hidden, hidden, g, lead))
        self.fc_out = StackedDense(hidden, out, g, lead)

    def forward(self, x, ef, edges=None):
        if self.layers == 1:
            return self.fc_out(x, ef, edges)
        y = self.act(self.fc_0(x, ef, edges))
        for i in range(1, self.layers - 1):
            y = self.act(getattr(self, f"fc_{i}")(y))
        return self.fc_out(y)


def aggregate(msg, real, deg, names: Sequence[str]):
    """Dense messages [*lead, B, N(dst), N(src), F], real in-edges [B, N,
    N], in-degrees [B, N] -> concat of the aggregations over the sources
    [*lead, B, N, F * len(names)]; a node without in-edges gets zeros."""
    m = real.to(msg.dtype)[..., None]
    d_safe = deg.clamp_min(1.0)[..., None]
    has = deg[..., None] > 0
    zero = torch.zeros((), dtype=msg.dtype, device=msg.device)
    sums = (msg * m).sum(-2)
    mean = sums / d_safe
    outs = []
    for name in names:
        if name == "mean":
            outs.append(mean)
        elif name == "sum":
            outs.append(sums)
        elif name == "max":
            outs.append(torch.where(has, torch.where(
                m > 0, msg, float("-inf")).amax(-2), zero))
        elif name == "min":
            outs.append(torch.where(has, torch.where(
                m > 0, msg, float("inf")).amin(-2), zero))
        elif name in ("std", "var"):
            var = torch.relu((msg * msg * m).sum(-2) / d_safe - mean * mean)
            out = torch.sqrt(var + EPS) if name == "std" else var
            outs.append(torch.where(has, out, zero))
        else:
            raise ValueError(f"unsupported aggregator {name!r}")
    return torch.cat(outs, -1)


def aggregate_sparse(msg, edges: SparseEdges, names: Sequence[str]):
    """Sparse twin of `aggregate`: msg [*lead, B, E, F]."""
    msg_m = msg * edges.edge_mask.to(msg.dtype)[..., None]
    deg = edges.deg
    d_safe = deg.clamp_min(1.0)[..., None]
    zero = torch.zeros((), dtype=msg.dtype, device=msg.device)
    sums = edges.segment_sum(msg_m)
    mean = sums / d_safe
    outs = []
    for name in names:
        if name == "mean":
            outs.append(mean)
        elif name == "sum":
            outs.append(sums)
        elif name == "max":
            outs.append(incidence_max(msg, edges))
        elif name == "min":
            outs.append(incidence_min(msg, edges))
        elif name in ("std", "var"):
            mean_sq = edges.segment_sum(msg_m * msg) / d_safe
            var = torch.relu(mean_sq - mean * mean)
            out = torch.sqrt(var + EPS) if name == "std" else var
            outs.append(torch.where(deg[..., None] > 0, out, zero))
        else:
            raise ValueError(f"unsupported aggregator {name!r}")
    return torch.cat(outs, -1)


def scale(agg, deg, names: Sequence[str], avg_d_log: float):
    """The degree scalers of the aggregations [..., B, N, F], concatenated
    in `names` order."""
    logd = torch.log(deg + 1.0)[..., None]
    outs = []
    for name in names:
        if name == "identity":
            outs.append(agg)
        elif name == "amplification":
            outs.append(agg * (logd / avg_d_log))
        elif name == "attenuation":
            outs.append(agg * (avg_d_log / logd.clamp_min(EPS)))
        else:
            raise ValueError(f"unsupported scaler {name!r}")
    return torch.cat(outs, -1)


class PNATower(nn.Module):
    """One PNA tower, or T of them stacked (`lead=(T,)`). forward(h [*lead,
    B, N, 2t] the concat(h, p) slice, p [*lead, B, N, t], e_field, real,
    node_mask, snorm_n, edges) -> (h_out, p_out) [*lead, B, N, out_dim]."""

    def __init__(self, t_in: int, out_dim: int, edge_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d_log: float, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None,
                 lead: tuple = ()):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d_log, self.dropout = avg_d_log, dropout
        self.graph_norm, self.batch_norm = graph_norm, batch_norm
        self.dropout_generator = dropout_generator or torch.Generator()
        d = t_in
        agg_w = d * len(self.aggregators) * len(self.scalers)
        self.pretrans_h = EdgeMLP(2 * d, edge_dim, d, d, pretrans_layers,
                                  "relu", g, lead)
        self.pretrans_p = EdgeMLP(d, edge_dim, d, d, pretrans_layers, "tanh",
                                  g, lead)
        self.posttrans_h = MLP(2 * d + agg_w, out_dim, out_dim,
                               posttrans_layers, "relu", g, lead)
        self.posttrans_p = MLP(d + agg_w, out_dim, out_dim, posttrans_layers,
                               "tanh", g, lead)
        if batch_norm:
            self.batchnorm_h = MaskedBatchNorm(out_dim, lead)

    def forward(self, h, p, e_field, real, node_mask, snorm_n, edges=None):
        if edges is not None:
            deg = edges.deg
            agg = lambda msg: aggregate_sparse(msg, edges, self.aggregators)
        else:
            deg = real.to(h.dtype).sum(2)               # in-degree per dst
            agg = lambda msg: aggregate(msg, real, deg, self.aggregators)
        agg_h = scale(agg(self.pretrans_h(h, e_field, edges)), deg,
                      self.scalers, self.avg_d_log)
        agg_p = scale(agg(self.pretrans_p(p, e_field, edges)), deg,
                      self.scalers, self.avg_d_log)
        h_out = self.posttrans_h(torch.cat([h, agg_h], -1))
        p_out = self.posttrans_p(torch.cat([p, agg_p], -1))
        if self.graph_norm:
            h_out = h_out * snorm_n[..., None]
        if self.batch_norm:
            h_out = self.batchnorm_h(h_out, node_mask)
        rate = self.dropout if self.training else 0.0
        drop = lambda t: hash_dropout(t, rate, self.dropout_generator)
        return drop(h_out), drop(p_out)


class PNALSPELayer(nn.Module):
    """A PNA-LSPE layer: the towers over slices of concat(h, p) and p (or
    over all of them without `divide_input`), the mixing layers mixing_h
    (leaky relu) and mixing_p (tanh), residuals. With `vmap_towers`
    (default: whenever `divide_input` and more than one tower) the towers
    are stacked under `towers`, else separate `tower_<t>`."""

    def __init__(self, in_dim: int, out_dim: int, edge_dim: int,
                 aggregators: Sequence[str] = ("mean", "max", "min", "std"),
                 scalers: Sequence[str] = SCALERS, avg_d_log: float = 1.0,
                 towers: int = 1, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = True, divide_input: bool = True,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 vmap_towers: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.n_towers, self.divide_input = towers, divide_input
        self.residual = residual and in_dim == out_dim
        self.t_in = in_dim // towers if divide_input else in_dim
        t_out = out_dim // towers
        self.vmap_towers = (divide_input and towers > 1
                            if vmap_towers is None
                            else vmap_towers and divide_input)
        kw = dict(aggregators=aggregators, scalers=scalers,
                  avg_d_log=avg_d_log, dropout=dropout, graph_norm=graph_norm,
                  batch_norm=batch_norm, pretrans_layers=pretrans_layers,
                  posttrans_layers=posttrans_layers, generator=g,
                  dropout_generator=dropout_generator)
        if self.vmap_towers:
            self.towers = PNATower(self.t_in, t_out, edge_dim,
                                   lead=(towers,), **kw)
        else:
            for t in range(towers):
                self.add_module(f"tower_{t}", PNATower(self.t_in, t_out,
                                                       edge_dim, **kw))
        self.mixing_h = dense(t_out * towers, out_dim, g)
        self.mixing_p = dense(t_out * towers, out_dim, g)

    def forward(self, h, p, e_field, adj, node_mask, snorm_n, edges=None):
        b, n, _ = h.shape
        real = in_edge_mask(adj, node_mask) if edges is None else None
        hp = torch.cat([h, p], -1)
        tt, t_in = self.n_towers, self.t_in
        args = (e_field, real, node_mask, snorm_n, edges)
        if self.vmap_towers:
            hp_t = hp[..., :tt * 2 * t_in].reshape(
                b, n, tt, 2 * t_in).permute(2, 0, 1, 3)
            p_t = p[..., :tt * t_in].reshape(b, n, tt, t_in).permute(
                2, 0, 1, 3)
            ho, po = self.towers(hp_t, p_t, *args)
            cat_h = ho.permute(1, 2, 0, 3).reshape(b, n, -1)
            cat_p = po.permute(1, 2, 0, 3).reshape(b, n, -1)
        else:
            outs = []
            for t in range(tt):
                if self.divide_input:
                    hs = hp[..., t * 2 * t_in:(t + 1) * 2 * t_in]
                    ps = p[..., t * t_in:(t + 1) * t_in]
                else:
                    hs, ps = hp, p
                outs.append(getattr(self, f"tower_{t}")(hs, ps, *args))
            cat_h = torch.cat([o[0] for o in outs], -1)
            cat_p = torch.cat([o[1] for o in outs], -1)
        h_out = nn.functional.leaky_relu(self.mixing_h(cat_h), 0.01)
        p_out = torch.tanh(self.mixing_p(cat_p))
        if self.residual:
            h_out, p_out = h + h_out, p + p_out
        mask_f = node_mask.to(h.dtype)[..., None]
        return h_out * mask_f, p_out * mask_f


class GRUCell(nn.Module):
    """flax's GRUCell: r = sigmoid(ir x + hr h), z = sigmoid(iz x + hz h),
    n = tanh(in x + r * hn h), h' = (1 - z) n + z h (the input layers and
    hn carry biases)."""

    def __init__(self, features: int, g: torch.Generator):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, dense(features, features, g))
        for name in ("hr", "hz"):
            self.add_module(name, dense(features, features, g, bias=False))
        self.hn = dense(features, features, g)

    def forward(self, carry, inputs):
        lin = lambda name, x: getattr(self, name)(x)
        r = torch.sigmoid(lin("ir", inputs) + lin("hr", carry))
        z = torch.sigmoid(lin("iz", inputs) + lin("hz", carry))
        n = torch.tanh(lin("in", inputs) + r * lin("hn", carry))
        return (1.0 - z) * n + z * carry


def as_names(value) -> Tuple[str, ...]:
    """Aggregator / scaler names from a tuple or the configs'
    space-separated string."""
    return tuple(value.split()) if isinstance(value, str) else tuple(value)


class PNALSPENet(LSPENetBase):
    """PNA (with the LSPE p channel) for graph regression and
    classification. forward(batch) -> [B, n_out]. Bond types are embedded
    at `edge_dim` (0: hidden_dim) with `edge_feat`. Dense mailboxes unless
    `sparse_edges` (then the batch must carry COO edges and the in-edge
    table). Weights from a `torch.Generator` seeded with `seed`, on
    `device` (default CUDA)."""

    def __init__(self, num_atom_type: int, num_bond_type: int,
                 hidden_dim: int = 64, out_dim: int = 64, n_layers: int = 4,
                 pos_enc_dim: int = 20, pe_init: str = "rand_walk",
                 towers: int = 4,
                 aggregators: Sequence[str] = ("mean", "max", "min", "std"),
                 scalers: Sequence[str] = SCALERS, avg_d_log: float = 1.0,
                 dropout: float = 0.0, in_feat_dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = True, edge_feat: bool = False,
                 edge_dim: int = 0, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, readout: str = "mean",
                 n_out: int = 1, gru: bool = False,
                 sparse_edges: Optional[bool] = None,
                 vmap_towers: Optional[bool] = None,
                 categorical_input: bool = True, in_feat_dim: int = 0,
                 seed: int = 0, device=None):
        super().__init__()
        g = self._init_base(
            num_atom_type=num_atom_type, hidden_dim=hidden_dim,
            pos_enc_dim=pos_enc_dim, pe_init=pe_init, readout=readout,
            categorical_input=categorical_input, in_feat_dim=in_feat_dim,
            in_feat_dropout=in_feat_dropout, seed=seed)
        self.sparse = bool(sparse_edges)
        self.edge_feat = edge_feat
        e_dim = edge_dim or hidden_dim
        if edge_feat:
            self.embedding_e = embedding(num_bond_type, e_dim, g)
        self.layers = nn.ModuleList(
            PNALSPELayer(
                hidden_dim, out_dim if i + 1 == n_layers else hidden_dim,
                e_dim if edge_feat else 0, aggregators=as_names(aggregators),
                scalers=as_names(scalers), avg_d_log=avg_d_log, towers=towers,
                dropout=dropout, graph_norm=graph_norm,
                batch_norm=batch_norm, residual=residual,
                pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers, vmap_towers=vmap_towers,
                generator=g, dropout_generator=self.dropout_generator)
            for i in range(n_layers))
        if gru:
            self.gru = GRUCell(hidden_dim, g)
        self._add_fusion(out_dim, pos_enc_dim, n_out, g, device)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        if self.sparse and (batch.edge_index is None
                            or batch.in_edges is None):
            raise ValueError("sparse_edges=True needs a batch collated "
                             "with with_coo=True")
        h, p = self._input(batch)
        edges = (make_sparse_edges(batch, dtype=h.dtype, with_incidence=True)
                 if self.sparse else None)
        e_field = None
        if self.edge_feat and batch.edge_type is not None:
            et = batch.edge_type
            if edges is not None:
                et = edge_ids_from_dense(et, edges.src, edges.dst)
            e_field = self.embedding_e(et)
        mask_f = batch.node_mask.to(h.dtype)
        snorm_n = mask_f / mask_f.sum(-1, keepdim=True).clamp_min(1).sqrt()
        for i, layer in enumerate(self.layers):
            h_t, p = layer(h, p, e_field, batch.adj, batch.node_mask,
                           snorm_n, edges)
            if hasattr(self, "gru") and i + 1 < len(self.layers):
                h_t = self.gru(h_t, h) * mask_f[..., None]
            h = h_t
        h, _ = self._fuse(h, p)
        return self._readout(h, batch.node_mask)


def average_log_degree(graphs) -> float:
    """The training set's mean of log(in-degree + 1) over its nodes (the
    reference's avg_d['log']); 1.0 for no nodes."""
    logs = []
    for g in graphs:
        deg = np.zeros(g.num_nodes)
        np.add.at(deg, g.edge_index[1], 1.0)
        logs.extend(np.log(deg + 1.0))
    return float(np.mean(logs)) if logs else 1.0

