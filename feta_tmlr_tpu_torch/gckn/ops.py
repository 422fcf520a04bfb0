"""GCKN device operations: path convolution, kernel, segment pooling.

The counterparts of the JAX package's `gckn/ops.py` (the reference's
`gckn_fast` path_conv, its dynamic pooling, the exp kernel and the
matrix inverse square root), in plain PyTorch. Every sum is the same bits
run to run on the card (`ops/segment.py`: the gather's backward and the
pooling are sorted-segment reductions, no atomics).

Memory: a path size of 8 on 128 ZINC-sized graphs has 7.5M paths, and a
[P, s, H] gather of all of them at once would take 7.7 GB at H = 32.
`path_conv` accumulates one path position at a time ([P, H]), and
`path_conv_agg` takes a block plan (`path_blocks`): runs of whole
segments of at most `block_rows` path rows each, pooled one after
another into their own rows of the output, so that no pooling sum
crosses a block and the output's bits do not depend on the block size
(the reference streamed under MAXRAM the same way). The gradient of a
node's features sums over the blocks whose paths read it, in block
order: the same bits run to run at one block size.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from feta_tmlr_tpu_torch.ops.segment import (
    gather_rows,
    segment_max,
    segment_sum,
)

EPS = 1e-6
# path rows a block of `path_conv_agg` holds at most (a segment with more
# rows gets a block of its own): 2^20 rows of 32 float32 are 128 MiB a
# temporary
BLOCK_ROWS = 1 << 20

Block = Tuple[int, int, int, int]     # rows [r0, r1), segments [g0, g1)


def exp_kernel(x, alpha):
    """kappa(x) = exp(alpha * (x - 1)) (the reference's kernels.py)."""
    return torch.exp(alpha * (x - 1.0))


def linear_kernel(x, *_):
    return x


KERNELS = {"exp": exp_kernel, "linear": linear_kernel}


def path_conv(features, path_indices):
    """emb[p] = mean_j features[path[p, j], j, :].

    features [V+1, S, H] per path position (dummy last row), path_indices
    [P, s] (s <= S) -> [P, H]. Padded rows index the zero dummy row (the
    pooling masks them)."""
    s = path_indices.shape[1]
    acc = gather_rows(features[:, 0], path_indices[:, 0])
    for j in range(1, s):
        acc = acc + gather_rows(features[:, j], path_indices[:, j])
    return acc / s


def segment_pool(values, segment_ids, num_segments, pooling="mean",
                 path_mask=None):
    """Per-node pooling over the paths of each node (the reference's
    dpooling): "sum", "mean" or "max" over `values` [P, H] by
    `segment_ids` [P], sorted ascending."""
    if pooling in ("sum", "mean"):
        if path_mask is not None:
            values = torch.where(path_mask[:, None], values,
                                 torch.zeros_like(values))
        out = segment_sum(values, segment_ids, num_segments,
                          indices_are_sorted=True)
        if pooling == "mean":
            ones = (path_mask.to(values.dtype) if path_mask is not None
                    else values.new_ones(values.shape[:1]))
            cnt = segment_sum(ones, segment_ids, num_segments,
                              indices_are_sorted=True)
            out = out / torch.clamp(cnt, min=1.0)[:, None]
        return out
    if pooling == "max":
        if path_mask is not None:
            values = torch.where(path_mask[:, None], values,
                                 torch.full_like(values, float("-inf")))
        out = segment_max(values, segment_ids, num_segments,
                          indices_are_sorted=True)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(f"unknown pooling {pooling!r}")


def path_blocks(segment_ids: np.ndarray, num_segments: int,
                block_rows: int = BLOCK_ROWS) -> List[Block]:
    """A plan of blocks over sorted `segment_ids` (host): each (r0, r1,
    g0, g1) holds rows r0..r1-1, whose ids lie in [g0, g1); the blocks
    cover every row and every segment, empty ones included, in order, and
    cut only between segments."""
    ids = np.asarray(segment_ids)
    n = ids.shape[0]
    blocks, r0, g0 = [], 0, 0
    while r0 < n:
        r = r0 + block_rows
        if r >= n:
            break
        r1 = int(np.searchsorted(ids, ids[r], side="left"))
        if r1 == r0:             # one segment longer than a block
            r1 = int(np.searchsorted(ids, ids[r0], side="right"))
        if r1 >= n:
            break
        g1 = int(ids[r1])
        blocks.append((r0, r1, g0, g1))
        r0, g0 = r1, g1
    blocks.append((r0, n, g0, num_segments))
    return blocks


def path_conv_agg(features, path_indices, segment_ids, num_segments,
                  pooling="mean", kappa=None, path_mask=None,
                  blocks: Optional[Sequence[Block]] = None):
    """path_conv -> kappa -> segment pooling (the reference's
    path_conv_agg.py), over `blocks` (`path_blocks`; all rows at once if
    none); `segment_ids` sorted ascending (`build_path_batch`'s layout)."""
    def run(r0, r1, g0, g1):
        emb = path_conv(features, path_indices[r0:r1])
        if kappa is not None:
            emb = kappa(emb)
        mask = None if path_mask is None else path_mask[r0:r1]
        return segment_pool(emb, segment_ids[r0:r1] - g0, g1 - g0, pooling,
                            mask)

    blocks = blocks or [(0, path_indices.shape[0], 0, num_segments)]
    return torch.cat([run(*block) for block in blocks])


def matrix_inverse_sqrt(mat, eps: float = 1e-2):
    """kappa(Gram)^{-1/2} by eigh, the reference's semantics: eigenvalues
    clamped at 0, then 1 / (sqrt(e) + eps), eps 1e-2 as at its call
    site. The backward is eigh's own."""
    w, v = torch.linalg.eigh(mat)
    inv = 1.0 / (torch.sqrt(torch.clamp(w, min=0.0)) + eps)
    return (v * inv[..., None, :]) @ v.transpose(-1, -2)


def normalize_rows(x, dim=-1):
    """L2 row normalisation with the EPS clamp (the reference's
    normalize_)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=EPS)
