"""Decentralized network topologies (paper Section 2.1).

NumPy only: a copy of ``repro.core.graph`` kept in the port so that it
never imports the JAX package (whose ``core/__init__`` imports jax);
the same seed gives bit-equal output.

A network is an undirected connected graph over m nodes, encoded by a binary
adjacency matrix W with zero diagonal (no self-loops, Assumption A1).
"""
from __future__ import annotations

import numpy as np


def _check(W: np.ndarray) -> np.ndarray:
    W = np.asarray(W)
    assert W.ndim == 2 and W.shape[0] == W.shape[1], "W must be square"
    assert np.array_equal(W, W.T), "W must be symmetric"
    assert np.all(np.diag(W) == 0), "no self-loops (A1)"
    return W.astype(np.float32)


def is_connected(W: np.ndarray) -> bool:
    """BFS reachability check (Assumption A1)."""
    m = W.shape[0]
    seen = np.zeros(m, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(W[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def erdos_renyi(m: int, p_connect: float, seed: int = 0,
                max_tries: int = 1000) -> np.ndarray:
    """Connected Erdős–Rényi graph G(m, p_c) — resamples until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        upper = rng.random((m, m)) < p_connect
        W = np.triu(upper, 1)
        W = (W | W.T).astype(np.float32)
        if is_connected(W):
            return _check(W)
    raise RuntimeError(f"could not sample a connected G({m},{p_connect})")


def ring(m: int) -> np.ndarray:
    W = np.zeros((m, m), dtype=np.float32)
    for i in range(m):
        W[i, (i + 1) % m] = W[(i + 1) % m, i] = 1.0
    if m == 2:  # avoid double edge
        W = np.minimum(W, 1.0)
    return _check(W)


def star(m: int) -> np.ndarray:
    W = np.zeros((m, m), dtype=np.float32)
    W[0, 1:] = W[1:, 0] = 1.0
    return _check(W)


def complete(m: int) -> np.ndarray:
    W = np.ones((m, m), dtype=np.float32) - np.eye(m, dtype=np.float32)
    return _check(W)


def grid2d(rows: int, cols: int) -> np.ndarray:
    """2-D torus-free grid — the natural embedding on a TPU mesh slice."""
    m = rows * cols
    W = np.zeros((m, m), dtype=np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                W[i, i + 1] = W[i + 1, i] = 1.0
            if r + 1 < rows:
                W[i, i + cols] = W[i + cols, i] = 1.0
    return _check(W)


def torus2d(rows: int, cols: int) -> np.ndarray:
    """2-D torus — matches TPU ICI wrap-around links."""
    m = rows * cols
    W = np.zeros((m, m), dtype=np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            j_right = r * cols + (c + 1) % cols
            j_down = ((r + 1) % rows) * cols + c
            if j_right != i:
                W[i, j_right] = W[j_right, i] = 1.0
            if j_down != i:
                W[i, j_down] = W[j_down, i] = 1.0
    return _check(W)


def make_graph(kind: str, m: int, p_connect: float = 0.5, seed: int = 0) -> np.ndarray:
    if kind == "erdos_renyi":
        return erdos_renyi(m, p_connect, seed)
    if kind == "ring":
        return ring(m)
    if kind == "star":
        return star(m)
    if kind == "complete":
        return complete(m)
    if kind == "grid":
        r = int(np.floor(np.sqrt(m)))
        while m % r:
            r -= 1
        return grid2d(r, m // r)
    if kind == "torus":
        r = int(np.floor(np.sqrt(m)))
        while m % r:
            r -= 1
        return torus2d(r, m // r)
    raise ValueError(f"unknown graph kind {kind!r}")


def degrees(W: np.ndarray) -> np.ndarray:
    return W.sum(axis=1)


class BlockTopology:
    """Adjacency-list topology with chunk-level block-sparsity queries.

    Stores the graph as per-node neighbour lists — O(m + edges) host
    memory — so large-m benchmarks never materialize an O(m^2) dense W
    just to derive the block structure the chunked engine needs.  The
    chunked neighbour sum partitions nodes into ``n_chunks`` contiguous
    chunks of ``mc = ceil(m / n_chunks)`` rows (the tail chunk is padded
    with isolated ghost nodes) and views W as an ``n_chunks x n_chunks``
    grid of (mc, mc) blocks; ``chunk_operands`` returns exactly the
    operands ``decentral``'s block schedule consumes.
    """

    def __init__(self, neighbors):
        self.m = len(neighbors)
        adj = []
        for i, js in enumerate(neighbors):
            js = np.unique(np.asarray(js, dtype=np.int64))
            assert i not in js, "no self-loops (A1)"
            assert js.size == 0 or (0 <= js[0] and js[-1] < self.m), \
                "neighbour index out of range"
            adj.append(js)
        self.neighbors = adj
        for i, js in enumerate(adj):            # symmetry (undirected)
            for j in js:
                assert i in adj[j], f"edge ({i},{j}) missing its reverse"

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "BlockTopology":
        W = _check(W)
        return cls([np.nonzero(W[i])[0] for i in range(W.shape[0])])

    @property
    def n_edges(self) -> int:
        return sum(js.size for js in self.neighbors) // 2

    def degrees(self) -> np.ndarray:
        return np.array([js.size for js in self.neighbors],
                        dtype=np.float32)

    def is_connected(self) -> bool:
        seen = np.zeros(self.m, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in self.neighbors[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())

    def to_dense(self) -> np.ndarray:
        """Dense adjacency — small-m parity checks only (O(m^2))."""
        W = np.zeros((self.m, self.m), dtype=np.float32)
        for i, js in enumerate(self.neighbors):
            W[i, js] = 1.0
        return _check(W)

    def _edge_arrays(self):
        """Directed edge list (both directions), as two int64 arrays."""
        counts = [js.size for js in self.neighbors]
        I = np.repeat(np.arange(self.m, dtype=np.int64), counts)
        J = (np.concatenate(self.neighbors) if self.m and sum(counts)
             else np.zeros(0, dtype=np.int64))
        return I, J

    def block_mask(self, n_chunks: int) -> np.ndarray:
        """(n_chunks, n_chunks) bool: which W blocks hold any edge."""
        mc = -(-self.m // n_chunks)
        I, J = self._edge_arrays()
        mask = np.zeros((n_chunks, n_chunks), dtype=bool)
        mask[I // mc, J // mc] = True
        return mask

    def chunk_operands(self, n_chunks: int):
        """Block operands for the chunked neighbour sum.

        Returns ``(W_diag, offsets, W_off)`` for ``mc``-row chunks
        (``m_pad = mc * n_chunks`` rows total, tail padded with zeros):

        - ``W_diag``: (m_pad, mc) — row i holds W[i, own-chunk columns];
          the per-device diagonal block, applied as a local dense dot.
        - ``offsets``: sorted tuple of ring shifts k in [1, n_chunks)
          with at least one nonzero block (d, (d+k) % n_chunks) — the
          statically-kept cross-chunk block diagonals.
        - ``W_off``: (len(offsets), m_pad, mc) — entry [o, i] holds
          W[i, columns of chunk (chunk(i)+offsets[o]) % n_chunks],
          applied after rotating B by ``offsets[o]`` chunks.
        """
        mc = -(-self.m // n_chunks)
        m_pad = mc * n_chunks
        I, J = self._edge_arrays()
        k = (J // mc - I // mc) % n_chunks
        W_diag = np.zeros((m_pad, mc), dtype=np.float32)
        loc = k == 0
        W_diag[I[loc], J[loc] % mc] = 1.0
        offsets = tuple(int(o) for o in sorted(np.unique(k[~loc])))
        W_off = np.zeros((len(offsets), m_pad, mc), dtype=np.float32)
        for o, shift in enumerate(offsets):
            sel = k == shift
            W_off[o, I[sel], J[sel] % mc] = 1.0
        return W_diag, offsets, W_off


def ring_of_cliques(cliques: int, size: int) -> BlockTopology:
    """``cliques`` complete graphs of ``size`` nodes, bridged in a ring.

    The canonical block-sparse benchmark topology: with chunk sizes that
    are multiples of ``size``, all edges land on the block diagonal plus
    the +-1 ring offsets, so the chunked engine keeps only 2 of the
    n_chunks-1 cross-chunk block diagonals.
    """
    assert size >= 1 and cliques >= 1
    m = cliques * size
    adj = [set() for _ in range(m)]
    for c in range(cliques):
        base = c * size
        for a in range(size):
            for b in range(a + 1, size):
                adj[base + a].add(base + b)
                adj[base + b].add(base + a)
    if cliques > 1:
        for c in range(cliques):                # bridge: last -> next first
            u = c * size + (size - 1)
            v = ((c + 1) % cliques) * size
            if u != v:
                adj[u].add(v)
                adj[v].add(u)
    top = BlockTopology([sorted(s) for s in adj])
    assert top.is_connected()
    return top


def k_regular(m: int, k: int) -> BlockTopology:
    """Circulant ring lattice: node i links to i +- 1..k/2 (mod m)."""
    assert k % 2 == 0 and 0 < k < m, "k must be even and in (0, m)"
    half = k // 2
    adj = [sorted({(i + d) % m for d in range(-half, half + 1)} - {i})
           for i in range(m)]
    top = BlockTopology(adj)
    assert top.is_connected()
    return top


def watts_strogatz(m: int, k: int, beta: float, seed: int = 0,
                   max_tries: int = 100) -> BlockTopology:
    """Watts–Strogatz small world: circulant lattice with each forward
    edge rewired to a uniform random target with probability ``beta``.
    Resamples until connected."""
    assert k % 2 == 0 and 0 < k < m
    rng = np.random.default_rng(seed)
    half = k // 2
    for _ in range(max_tries):
        adj = [{(i + d) % m for d in range(-half, half + 1)} - {i}
               for i in range(m)]
        for i in range(m):
            for d in range(1, half + 1):
                j = (i + d) % m
                if rng.random() >= beta or j not in adj[i]:
                    continue
                choices = [t for t in range(m)
                           if t != i and t not in adj[i]]
                if not choices:
                    continue
                t = int(rng.choice(choices))
                adj[i].discard(j)
                adj[j].discard(i)
                adj[i].add(t)
                adj[t].add(i)
        top = BlockTopology([sorted(s) for s in adj])
        if top.is_connected():
            return top
    raise RuntimeError(f"could not sample a connected WS({m},{k},{beta})")


def metropolis_weights(W: np.ndarray) -> np.ndarray:
    """Doubly-stochastic Metropolis–Hastings mixing matrix (used by the
    average-consensus and D-subGD baselines, Yadav & Salapaka 2007)."""
    m = W.shape[0]
    deg = degrees(W)
    M = np.zeros_like(W, dtype=np.float64)
    for i in range(m):
        for j in np.nonzero(W[i])[0]:
            M[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(M, 1.0 - M.sum(axis=1))
    return M.astype(np.float32)
