"""Exact path-kernel Gram matrices, as products.

The counterpart of the JAX package's `gckn/path_kernel.py` (the
reference's exhaustive path kernel, gckn/path_kernel.py). For paths of s
nodes, P1 [m1, s] and P2 [m2, s],

    out_s[p, q] = (1/s) * sum_i <x1[P1[p, i]], x2[P2[q, i]]>
                = (1/s) * <F1[p], F2[q]>,  F[p] = concat_i x[P[p, i]],

so each graph pair's block at one path length is one product F1 @ F2^T,
and pairs whose padded path counts share a bucket are stacked into one
batched product. The exp map and the length / `coef` / `normalize` /
`cum` semantics are the reference's `pathkernel`, including its quirk that
a length with no paths on either side contributes exp((0 - 1)/sigma^2).

`path_filter_response` is the reference's `dfs` scorer: every simple
path of k nodes scored against position filters, prefix-cumulatively.
The reference's backtracking restore zeroes prefix slots between siblings
(path_kernel.py:46-47, restored at :54 after the first child returns), so
slot j keeps its prefix sum only for paths whose steps j..k-2 all took
the first unvisited neighbour; every other path contributes
exp((0 - 1)/sigma^2) there. That is reproduced (`reference_semantics`);
False gives the clean all-prefixes scoring.

The products run on `device` (CUDA unless the caller passes "cpu").
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.gckn.pathenum import enumerate_paths

# elements of one stacked [P, Ma, Mb] similarity block at most
_BLOCK_BUDGET = 1 << 26


def exp_kernel(x, sigma: float = 0.6):
    """The reference's `exp` map (path_kernel.py:5-7)."""
    return torch.exp((x - 1.0) / sigma ** 2)


def _graph_fields(g) -> Tuple[np.ndarray, np.ndarray, int]:
    if isinstance(g, tuple):
        x, edge_index = g
    else:
        x, edge_index = g.x, g.edge_index
    x = np.asarray(x, dtype=np.float32)
    return x, np.asarray(edge_index), x.shape[0]


def _path_feature_table(graphs: Sequence, k: int
                        ) -> List[List[np.ndarray]]:
    """feats[g][s-1]: [m_gs, s*d] concatenated node features per path."""
    feats: List[List[np.ndarray]] = []
    for g in graphs:
        x, edge_index, n = _graph_fields(g)
        paths, _ = enumerate_paths(edge_index, n, k)
        feats.append([x[p].reshape(p.shape[0], p.shape[1] * x.shape[1])
                      for p in paths])
    return feats


def _bucket(m: int) -> int:
    """Path counts padded to powers of two (at least 8)."""
    b = 8
    while b < m:
        b *= 2
    return b


def _pair_block(fa, ma, fb, mb, inv_s, sigma, normalize):
    """[P]: the masked mean (normalize) or sum of exp((sim/s - 1) /
    sigma^2) over the valid path pairs of each stacked pair."""
    sim = torch.einsum("pmd,pnd->pmn", fa, fb) * inv_s
    vals = torch.exp((sim - 1.0) / sigma ** 2)
    pair_mask = ma[:, :, None] * mb[:, None, :]
    total = torch.sum(vals * pair_mask, dim=(1, 2))
    if normalize:
        return total / torch.sum(pair_mask, dim=(1, 2))
    return total


def _per_length_values(feats: List[List[np.ndarray]], s: int,
                       pairs: List[Tuple[int, int]], sigma: float,
                       normalize: bool, device) -> np.ndarray:
    """val[p] for every graph pair at path length s (s nodes)."""
    vals = np.empty(len(pairs), dtype=np.float64)
    # the reference skips empty path sets: out[j] stays 0, and
    # exp((0-1)/sigma^2) still enters the kernel value
    empty_val = float(np.exp(-1.0 / sigma ** 2))

    groups = defaultdict(list)   # (Ma, Mb) -> [(pair_idx, ia, ib)]
    for idx, (ia, ib) in enumerate(pairs):
        m1 = feats[ia][s - 1].shape[0]
        m2 = feats[ib][s - 1].shape[0]
        if m1 == 0 or m2 == 0:
            vals[idx] = empty_val
            continue
        groups[(_bucket(m1), _bucket(m2))].append((idx, ia, ib))

    d = next((fl[s - 1].shape[1] for fl in feats if fl[s - 1].shape[0]),
             None)
    for (Ma, Mb), entries in groups.items():
        chunk = max(1, _BLOCK_BUDGET // (Ma * Mb))
        for lo in range(0, len(entries), chunk):
            part = entries[lo:lo + chunk]
            fa = np.zeros((len(part), Ma, d), dtype=np.float32)
            fb = np.zeros((len(part), Mb, d), dtype=np.float32)
            ma = np.zeros((len(part), Ma), dtype=np.float32)
            mb = np.zeros((len(part), Mb), dtype=np.float32)
            for row, (_, ia, ib) in enumerate(part):
                f1, f2 = feats[ia][s - 1], feats[ib][s - 1]
                fa[row, :f1.shape[0]] = f1
                fb[row, :f2.shape[0]] = f2
                ma[row, :f1.shape[0]] = 1.0
                mb[row, :f2.shape[0]] = 1.0
            out = _pair_block(*(torch.from_numpy(a).to(device)
                                for a in (fa, ma, fb, mb)),
                              1.0 / s, sigma, normalize).cpu().numpy()
            for row, (idx, _, _) in enumerate(part):
                vals[idx] = out[row]
    return vals


def path_kernel_gram(graphs: Sequence, k: int, *, coef: float = 2.0,
                     normalize: bool = False, cum: bool = False,
                     sigma: float = 0.6, device=None) -> np.ndarray:
    """Gram matrix [n, n] (float64) of the exhaustive path kernel over
    `graphs` (`(x, edge_index)` tuples or `Graph`s): per path length
    s = 1..k the exp map of the mean positional node similarity over every
    pair of simple paths, summed (or averaged, `normalize`) over pairs;
    with `cum` the lengths weighted by coef**(s-1), else length k alone
    (the reference's `pathkernel`)."""
    dev = resolve_device(device)
    feats = _path_feature_table(graphs, k)
    n = len(feats)
    pairs = [(i, j) for i in range(n) for j in range(i, n)]
    per_len = np.stack([
        _per_length_values(feats, s, pairs, sigma, normalize, dev)
        for s in range(1, k + 1)])                    # [k, n_pairs]
    if cum:
        weights = coef ** np.arange(k)
        flat = (per_len * weights[:, None]).sum(0)
    else:
        flat = per_len[-1]
    gram = np.zeros((n, n), dtype=np.float64)
    for idx, (i, j) in enumerate(pairs):
        gram[i, j] = gram[j, i] = flat[idx]
    return gram


def path_kernel_pair(g1, g2, k: int, *, sigma: float = 0.6,
                     device=None) -> np.ndarray:
    """[k]: the exp-map mean over path pairs at each path length (the
    reference's `pathkernel_compare2`)."""
    dev = resolve_device(device)
    feats = _path_feature_table([g1, g2], k)
    return np.stack([
        _per_length_values(feats, s, [(0, 1)], sigma, True, dev)[0]
        for s in range(1, k + 1)])


def _first_child_steps(paths_k: np.ndarray, edge_index: np.ndarray,
                       n_nodes: int) -> np.ndarray:
    """ind[m, t]: step t -> t+1 of path m chose the first (lowest-index)
    neighbour of node t not already on the path, the child the
    reference's recursion visits before its sibling restore zeroes the
    prefix slots."""
    m, k = paths_k.shape
    adj = [[] for _ in range(n_nodes)]
    for s, d in zip(*np.asarray(edge_index)):
        adj[int(s)].append(int(d))
    adj = [sorted(a) for a in adj]
    ind = np.zeros((m, k - 1), dtype=bool)
    for row in range(m):
        path = paths_k[row]
        on_path = set()
        for t in range(k - 1):
            on_path.add(int(path[t]))
            first = next((v for v in adj[int(path[t])]
                          if v not in on_path), -1)
            ind[row, t] = first == int(path[t + 1])
    return ind


def path_filter_response(g, filters: np.ndarray, sigma: float = 0.6,
                         reference_semantics: bool = True,
                         device=None) -> torch.Tensor:
    """[k, p]: simple paths of k nodes scored against position filters
    [k, p, d] (the reference's `dfs`): position i contributes
    <x[path[i]], filters[i]>, and output[j] sums exp(prefix mean to j)
    over the paths, with the sibling-restore quirk under
    `reference_semantics`."""
    dev = resolve_device(device)
    filters = np.asarray(filters, dtype=np.float32)
    k, p, _ = filters.shape
    x, edge_index, n = _graph_fields(g)
    paths, _ = enumerate_paths(edge_index, n, k)
    pk = paths[k - 1]
    if pk.shape[0] == 0:
        return torch.zeros((k, p), dtype=torch.float32, device=dev)
    base = torch.einsum("mkd,kpd->mkp", torch.from_numpy(x[pk]).to(dev),
                        torch.from_numpy(filters).to(dev))
    divider = torch.arange(1, k + 1, dtype=torch.float32,
                           device=dev)[None, :, None]
    prefixed = torch.cumsum(base, 1) / divider
    if reference_semantics and k > 1:
        ind = _first_child_steps(pk, edge_index, n)
        # slot j survives iff steps j..k-2 all took the first child: a
        # reversed cumulative AND over the step indicators
        survive = np.concatenate(
            [np.cumprod(ind[:, ::-1], axis=1)[:, ::-1].astype(bool),
             np.ones((pk.shape[0], 1), dtype=bool)], axis=1)
        prefixed = prefixed * torch.from_numpy(survive).to(dev)[:, :, None]
    return exp_kernel(prefixed, sigma).sum(0)
