"""Dense batched GNN modules over a padded adjacency [B, N, N]:

  DenseGCNConv   x' = D~^-1/2 (A + I) D~^-1/2 X W + b (the missing self
                 loops of real nodes filled)
  DenseGINEPlus  GINE+ multi-hop message passing:
                 x' = MLP((1 + eps) x + sum_hops sum_j relu(x_j (+ e_ij)))
                 over the powers of the adjacency
  DenseGENGCN    the multi-hop Laplacian polynomial sum_k h_k L^k (X W) + b
                 with learnable per-hop gains h (static: the dynamic
                 coefficients are not read)

Parameters keep the JAX package's flax names (`kernel_proj`, `bias`,
`eps`, `h`, `mlp_fc1`, `mlp_fc2`) so that `convert.from_flax` copies them.
Each product over the nodes goes through `ops/cheb.py::node_matmul`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from feta_tmlr_tpu_torch.nn.layers import dense
from feta_tmlr_tpu_torch.ops.cheb import node_matmul
from feta_tmlr_tpu_torch.ops.laplacian import (
    gcn_norm_dense,
    graph_laplacian_dense,
)
from feta_tmlr_tpu_torch.ops.masking import pair_mask


class DenseGCNConv(nn.Module):
    """GCN layer over a dense (possibly weighted) symmetric adjacency."""

    def __init__(self, in_features: int, features: int,
                 add_self_loops: bool = True, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.add_self_loops = add_self_loops
        self.kernel_proj = dense(in_features, features, g, bias=False)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, adj, node_mask):
        an = gcn_norm_dense(adj, node_mask,
                            add_self_loops=self.add_self_loops)
        out = node_matmul(an, self.kernel_proj(x))
        return out if self.bias is None else out + self.bias


class DenseGINEPlus(nn.Module):
    """GINE+ over `num_hops` powers of the masked adjacency; `edge_attr`
    [B, N, N, D] (optional) is added to each neighbour's features before
    the ReLU."""

    def __init__(self, in_features: int, features: int, num_hops: int = 1,
                 train_eps: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.num_hops = num_hops
        self.eps = nn.Parameter(torch.zeros(1)) if train_eps else None
        self.mlp_fc1 = dense(in_features, 2 * features, g)
        self.mlp_fc2 = dense(2 * features, features, g)

    def forward(self, x, adj, node_mask, edge_attr=None):
        a = adj * pair_mask(node_mask).to(x.dtype)
        agg = x if self.eps is None else (1.0 + self.eps) * x
        cur = a
        for _ in range(self.num_hops):
            if edge_attr is not None:
                msg = torch.relu(x[..., None, :, :] + edge_attr)
                agg = agg + (cur[..., None] * msg).sum(-2)
            else:
                agg = agg + node_matmul(cur, torch.relu(x))
            cur = node_matmul(cur, a)
        return self.mlp_fc2(torch.relu(self.mlp_fc1(agg)))


class DenseGENGCN(nn.Module):
    """sum_k h_k L^k (X W) + b over k < num_hops, L the unscaled Laplacian
    under `normalization` (`ops/laplacian.py::graph_laplacian_dense`); h
    drawn from U[0, 1)."""

    def __init__(self, in_features: int, features: int, num_hops: int = 4,
                 normalization: Optional[str] = "sym", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.normalization = normalization
        self.h = nn.Parameter(torch.rand(num_hops, generator=g))
        self.kernel_proj = dense(in_features, features, g, bias=False)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, adj, node_mask):
        lap = graph_laplacian_dense(adj, node_mask, self.normalization)
        cur = self.kernel_proj(x)
        out = self.h[0] * cur                       # hop 0: the identity
        for k in range(1, self.h.shape[0]):
            cur = node_matmul(lap, cur)
            out = out + self.h[k] * cur
        return out if self.bias is None else out + self.bias
