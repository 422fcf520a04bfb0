"""Path and walk enumeration: the C++ DFS of `native/pathenum.cpp` and its
pure-Python twins.

The counterpart of the JAX package's `gckn/pathenum.py` (the reference's
Cython `get_paths`). The C++ source is compiled from the checkout at first
use into `build/` (`ops/kernels/host_build.py`); the committed binary
under `native/` is never loaded. The implementation is an explicit
argument: `impl="native"` (the default) raises if the build fails, and
`impl="python"` runs the twin, ~80x slower at path size 8. Both give the
same paths in the same order: rows grouped by start node (ascending), DFS
order within a node, neighbours visited in ascending order.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from feta_tmlr_tpu_torch.ops.kernels import host_build

_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = host_build.load("pathenum")
    if not _bound:
        i32p = ctypes.POINTER(ctypes.c_int32)
        for count_name, fill_name in (("count_paths", "fill_paths"),
                                      ("count_walks", "fill_walks")):
            getattr(lib, count_name).argtypes = [
                i32p, i32p, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64)]
            getattr(lib, count_name).restype = ctypes.c_int
            getattr(lib, fill_name).argtypes = [
                i32p, i32p, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(i32p)]
            getattr(lib, fill_name).restype = ctypes.c_int
        _bound = True
    return lib


def _to_csr(edge_index: np.ndarray, n_nodes: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted CSR adjacency (neighbours ascending: a fixed DFS order)."""
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int32)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, dst.astype(np.int32)


def _native(count_name: str, fill_name: str, edge_index, n_nodes, k):
    lib = _lib()
    indptr, indices = _to_csr(edge_index, n_nodes)
    counts = np.zeros((k, n_nodes), dtype=np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    getattr(lib, count_name)(
        indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
        n_nodes, k, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    out = [np.empty((int(counts[s - 1].sum()), s), dtype=np.int32)
           for s in range(1, k + 1)]
    ptrs = (i32p * k)(*[p.ctypes.data_as(i32p) for p in out])
    getattr(lib, fill_name)(
        indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
        n_nodes, k, ptrs)
    return out, counts


def _check_impl(impl: str) -> None:
    if impl not in ("native", "python"):
        raise ValueError(f"impl {impl!r}: 'native' or 'python'")


def enumerate_paths(edge_index: np.ndarray, n_nodes: int, k: int,
                    impl: str = "native"
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """All simple paths with 1..k nodes from every start node.

    Returns:
      paths: list of k arrays; paths[s-1] has shape [n_paths_s, s] int32.
      counts: [k, n_nodes] int64, counts[s-1, u] = #size-s paths from u.
    """
    _check_impl(impl)
    if impl == "python":
        return enumerate_paths_py(edge_index, n_nodes, k)
    return _native("count_paths", "fill_paths", edge_index, n_nodes, k)


def enumerate_walks(edge_index: np.ndarray, n_nodes: int, k: int,
                    impl: str = "native"
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """All walks with 1..k nodes (revisits allowed, no immediate
    backtracking: the reference's `all_walks`)."""
    _check_impl(impl)
    if impl == "python":
        return enumerate_walks_py(edge_index, n_nodes, k)
    return _native("count_walks", "fill_walks", edge_index, n_nodes, k)


def enumerate_walks_py(edge_index: np.ndarray, n_nodes: int, k: int
                       ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The pure-Python twin of `enumerate_walks`."""
    indptr, indices = _to_csr(edge_index, n_nodes)
    adj = [indices[indptr[u]:indptr[u + 1]].tolist()
           for u in range(n_nodes)]
    out: List[List[List[int]]] = [[] for _ in range(k)]
    counts = np.zeros((k, n_nodes), dtype=np.int64)

    def dfs(path, start):
        out[len(path) - 1].append(list(path))
        counts[len(path) - 1, start] += 1
        if len(path) >= k:
            return
        prev = path[-2] if len(path) >= 2 else -1
        for v in adj[path[-1]]:
            if v == prev:
                continue
            path.append(v)
            dfs(path, start)
            path.pop()

    for u in range(n_nodes):
        dfs([u], u)
    walks = [np.asarray(out[s], dtype=np.int32).reshape(-1, s + 1)
             for s in range(k)]
    return walks, counts


def enumerate_paths_py(edge_index: np.ndarray, n_nodes: int, k: int
                       ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The pure-Python twin of `enumerate_paths` (the same order)."""
    indptr, indices = _to_csr(edge_index, n_nodes)
    adj = [indices[indptr[u]:indptr[u + 1]].tolist()
           for u in range(n_nodes)]
    out: List[List[List[int]]] = [[] for _ in range(k)]
    counts = np.zeros((k, n_nodes), dtype=np.int64)

    def dfs(path, visited, start):
        out[len(path) - 1].append(list(path))
        counts[len(path) - 1, start] += 1
        if len(path) >= k:
            return
        for v in adj[path[-1]]:
            if v not in visited:
                visited.add(v)
                path.append(v)
                dfs(path, visited, start)
                path.pop()
                visited.discard(v)

    for u in range(n_nodes):
        dfs([u], {u}, u)
    paths = [np.asarray(out[s], dtype=np.int32).reshape(-1, s + 1)
             for s in range(k)]
    return paths, counts
