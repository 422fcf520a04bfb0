"""The FeTA model over packed rows: several graphs in each node row.

`data/pack.py` places ~row_len / mean-size graphs in each row, so every
feature product runs on fewer, fuller rows. Attention, the coefficient GCN
and the Chebyshev Laplacian become block-diagonal under the pair mask
graph_id[i] == graph_id[j] of real nodes; per-graph quantities (the filter
coefficients, the pooled readout) go through the membership matrix
[B, N, G], so a pooled mean is one product. On the same graphs and weights
the model equals `DiffGraphTransformerGenGCN` up to summation order, and it
has the same parameters under the same names: one state dict, and one
`convert.from_flax` of the JAX package's flax tree, serve both.

Every layer of a packed row takes the score route with the plain
pair-masked chain (`nn/layers.py`), on every device: no kernel takes a pair
mask, and the JAX package routes packed rows the same way. The packed path
launches no kernel.
"""

from __future__ import annotations

import torch

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder, FilterCoefficientHead
from feta_tmlr_tpu_torch.nn.models import _FeTATransformer, embed
from feta_tmlr_tpu_torch.ops.cheb import cheb_filter_dynamic_per_node
from feta_tmlr_tpu_torch.ops.laplacian import (
    cheb_scaled_laplacian,
    gcn_norm_directed,
)


def membership(graph_id: torch.Tensor, node_mask: torch.Tensor,
               n_graphs: int, dtype=torch.float32) -> torch.Tensor:
    """[B, N, G] one-hot graph membership (0 on padding)."""
    slots = torch.arange(n_graphs, device=graph_id.device)
    return ((graph_id.long()[..., None] == slots)
            & node_mask.bool()[..., None]).to(dtype)


def per_graph_mean(x: torch.Tensor, memb: torch.Tensor) -> torch.Tensor:
    """x [B, (H,) N, D], memb [B, N, G] -> the mean over each graph's
    nodes [B, (H,) G, D] (empty slots 0)."""
    cnt = memb.sum(-2).clamp_min(1.0)                    # [B, G]
    if x.dim() == 4:
        return (torch.einsum("bhnd,bng->bhgd", x, memb)
                / cnt[:, None, :, None])
    return torch.einsum("bnd,bng->bgd", x, memb) / cnt[:, :, None]


class PackedFilterCoefficientHead(FilterCoefficientHead):
    """`FilterCoefficientHead` (the same parameters) over the
    block-diagonal attention graph, its mean pool taken per packed graph:
    forward(attn [B, H, N, N], node_mask, memb) -> [B, H, G, C]."""

    def forward(self, attn, node_mask, memb):
        s = gcn_norm_directed(attn.detach(), node_mask[:, None, :]).sum(2)
        hid = torch.tanh(s[..., None] * self.gcn_kernel.sum(0)
                         + self.gcn_bias)                # [B, H, N, C]
        return self.coeff_linear(per_graph_mean(hid, memb))


class PackedFeTAEncoder(FeTAEncoder):
    """The FeTA encoder (dynamic Chebyshev filter) over packed rows:
    forward(x, pe, adj, node_mask, graph_id, graph_mask, degree) ->
    (out [B, N, D], memb [B, N, G], coefficients [B, Lf*H, G, C]).

    Only the 'sym' Laplacian and the dynamic Chebyshev filter: 'rw' and
    None need each graph's own largest eigenvalue, and a power iteration
    over a row's block-diagonal Laplacian would scale every graph of the
    row by the row's maximum."""

    coeff_head_cls = PackedFilterCoefficientHead

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.laplacian_norm != "sym":
            raise NotImplementedError(
                "packed batches take only the 'sym' Chebyshev "
                "normalisation: 'rw' and None need each graph's own "
                "lambda_max, which a row-level power iteration over the "
                "block-diagonal Laplacian would replace by the row's; use "
                "the unpacked FeTAEncoder for them")
        if self.gnn_type != "ChebConvDynamic" \
                or self.learn_only_filter_order_coeff:
            raise NotImplementedError(
                "packed batches take only the dynamic Chebyshev filter "
                "(gnn_type ChebConvDynamic with per-graph weights)")

    def forward(self, x, pe, adj, node_mask, graph_id, graph_mask,
                degree=None):
        b, n, d = x.shape
        h, k = self.n_heads, self.filter_order
        dh = d // h
        g_max = graph_mask.shape[1]
        m = node_mask.bool()
        pair = ((graph_id[:, :, None] == graph_id[:, None, :])
                & m[:, :, None] & m[:, None, :])
        memb = membership(graph_id, node_mask, g_max, x.dtype)
        lhat = cheb_scaled_laplacian(adj, node_mask, normalization="sym")
        mask_f = node_mask.to(x.dtype)[..., None]
        out = x
        filtered_sum = None
        coeffs = []
        for i, layer in enumerate(self.layers):
            filtered = self.filtered(i)
            out, attn, heads = layer(out, pe, node_mask, degree,
                                     need_heads=filtered, pair_mask=pair)
            if not filtered:
                continue
            coeff = self.coeff_head(attn, node_mask, memb)  # [B, H, G, C]
            coeffs.append(coeff)
            # each node's weights are its graph's: a product with the
            # one-hot membership, exact (one term a node), 0 on padding,
            # whose backward is a product too (a gather's would scatter-add
            # with atomics on the card, in an order that changes from run
            # to run)
            w_node = torch.einsum("bng,bhgc->bhnc", memb, coeff).reshape(
                b, h, n, k, dh, dh)
            filt = cheb_filter_dynamic_per_node(heads.transpose(1, 2), lhat,
                                                w_node, self.cheb_bias)
            filt = filt.transpose(1, 2).reshape(b, n, d) * mask_f
            if self.use_skip_conn:
                filtered_sum = (filt if filtered_sum is None
                                else filtered_sum + filt)
            else:                   # the filtered signal feeds the next layer
                out = filt
        if filtered_sum is not None:
            out = self.linear_cat(torch.cat([out, filtered_sum], dim=-1))
        coeff = (torch.cat(coeffs, dim=1) if coeffs
                 else x.new_zeros((b, 0, g_max, self.num_coefficients)))
        return out, memb, coeff


class PackedDiffGraphTransformerGenGCN(_FeTATransformer):
    """The packed twin of `DiffGraphTransformerGenGCN` (the same
    parameters, drawn in the same order from `seed`): forward(batch,
    regularization) on a `pack_graphs` batch returns (logits [B, G,
    nb_class], reg), reg the mean Frobenius norm of the valid slots'
    coefficients."""

    encoder_cls = PackedFeTAEncoder

    def __init__(self, in_size: int, nb_class: int, d_model: int,
                 nb_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, nb_layers: int = 4,
                 batch_norm: bool = False, lap_pos_enc: bool = False,
                 lap_pos_enc_dim: int = 0, filter_order: int = 4,
                 last_layer_filter: bool = True, use_skip_conn: bool = True,
                 seed: int = 0, device=None):
        super().__init__(in_size, nb_class, d_model, nb_heads,
                         dim_feedforward, dropout, nb_layers, batch_norm,
                         lap_pos_enc, lap_pos_enc_dim, filter_order,
                         last_layer_filter=last_layer_filter,
                         use_skip_conn=use_skip_conn, seed=seed,
                         device=device)

    def forward(self, batch: GraphBatch, regularization: float = 0.0):
        out, memb, coeff = self.encoder(
            embed(self, batch), batch.pe, batch.adj, batch.node_mask,
            batch.graph_id, batch.graph_mask, degree=batch.degree)
        logits = self.classifier(per_graph_mean(out, memb))
        if regularization <= 0 or coeff.shape[1] == 0:
            return logits, logits.new_zeros(())
        # [B, Lf*H, G, C] -> one [Lf*H, C] block a graph slot; empty slots
        # (coefficients 0) take norm 1 before the mask: sqrt's gradient at
        # 0 is inf, and inf * 0 would poison the sum
        bb, lh, gg, cc = coeff.shape
        sq = (coeff.transpose(1, 2).reshape(bb * gg, lh, cc) ** 2).sum((1, 2))
        valid = batch.graph_mask.reshape(-1)
        norms = torch.sqrt(torch.where(valid, sq, torch.ones_like(sq)))
        gm = valid.to(norms.dtype)
        return logits, (norms * gm).sum() / gm.sum().clamp_min(1.0)
