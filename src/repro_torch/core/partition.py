"""Graph partitioning for EHYB (paper §3.1, Algorithm 1 line 2) — host side.

A numpy copy of ``repro.core.partition``: the same four strategies give the
same partitions.  As in the paper (which calls METIS), these are
capacity-constrained partitioners: every row/column vertex goes to a
partition such that

* every partition holds at most ``vec_size`` vertices (the paper's Eq. 1–2
  cache sizing — uniform partitions so each partition's x-slice fits one
  thread block's shared memory), and
* the fraction of matrix entries whose column lies in the same partition as
  their row ("in-partition fraction") is maximized — that fraction is exactly
  the fraction of x-reads served from the explicit cache.

Registered strategies: ``natural`` (contiguous index blocks), ``bfs``
(greedy BFS graph growing with an FM-lite refinement pass — the METIS
stand-in and the one the port's main path uses), ``mincut`` (recursive
column-net min-cut bisection) and ``hub`` (degree-sorted hub extraction
over a base strategy).

Cache sizing has two forms: :func:`choose_vec_size` with the reference's
constants (what the CPU plan uses, so CPU builds are bit-identical to the
JAX package's) and :func:`choose_vec_size_cuda`, the paper's own Eq. 1–2
with the card's shared memory per block and SM count.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable, Dict

import numpy as np

from .matrices import SparseCSR


@dataclasses.dataclass
class Partition:
    n: int                 # true dimension
    n_pad: int             # n_parts * vec_size  (padding vertices have no entries)
    n_parts: int
    vec_size: int
    part_vec: np.ndarray   # (n,) int32: vertex -> partition
    # perm[new_vertex] = old_vertex; vertices of partition p occupy
    # [p*vec_size, (p+1)*vec_size). Padding slots hold old index == n_pad
    # sentinel (>= n) and are placed at the tail of each partition.
    perm: np.ndarray       # (n_pad,) int64
    inv_perm: np.ndarray   # (n_pad,) int64: old (padded) vertex -> new slot
    # --- provenance (filled by make_partition) ---------------------------
    method: str = ""       # registry name of the strategy that produced this
    seconds: float = 0.0   # wall-clock partitioning time

    def in_partition_fraction(self, m: SparseCSR) -> float:
        rows = np.repeat(np.arange(m.n), m.row_lengths())
        same = self.part_vec[rows] == self.part_vec[m.indices]
        return float(np.mean(same)) if m.nnz else 1.0

    def stats(self, m: SparseCSR) -> dict:
        """Pattern-level quality numbers (no EHYB build): the in-partition
        fraction plus the ELL/ER shape this partition induces."""
        rows = np.repeat(np.arange(m.n), m.row_lengths())
        same = self.part_vec[rows] == self.part_vec[m.indices]
        in_counts = np.bincount(rows[same], minlength=m.n)
        out_counts = np.bincount(rows[~same], minlength=m.n)
        return {
            "in_part_fraction": float(same.mean()) if m.nnz else 1.0,
            "ell_width": int(max(int(in_counts.max()), 1)),
            "er_rows": int((out_counts > 0).sum()),
            "er_width": int(max(int(out_counts.max()), 1)),
            "er_entries": int(out_counts.sum()),
        }


# ---------------------------------------------------------------------------
# cache sizing — the paper's Eq. 1–2
# ---------------------------------------------------------------------------

def choose_vec_size(n: int, dtype_bytes: int = 4,
                    vmem_budget_bytes: int = 4 * 1024 * 1024,
                    p_units: int = 8, sublane: int = 8,
                    max_local_index: int = 1 << 16) -> tuple[int, int]:
    """Paper Eq. 1–2: smallest integer K with dim·τ/(K·P) < budget.

    The defaults are the reference's (a 4 MiB cache budget, 8 units, 8-row
    alignment); the CPU plan keeps them so its builds match the JAX
    package's bit for bit.  :func:`choose_vec_size_cuda` passes the card's
    own constants.

    Returns (n_parts, vec_size); vec_size is ``sublane``-aligned and < 2^16
    so local column indices fit uint16 (paper §3.4).
    """
    if n <= 0:
        raise ValueError("n must be positive")
    k = 1
    while True:
        n_parts = k * p_units
        vec_size = -(-n // n_parts)                    # ceil
        vec_size = -(-vec_size // sublane) * sublane   # sublane align
        if vec_size * dtype_bytes < vmem_budget_bytes and vec_size < max_local_index:
            return n_parts, vec_size
        k += 1


def choose_vec_size_cuda(n: int, dtype_bytes: int, smem_per_block: int,
                         sm_count: int, rhs: int = 1) -> tuple[int, int]:
    """The paper's Eq. 1–2 on an NVIDIA card: budget = the shared memory one
    block may opt into, P = the SM count, 32-row (warp) alignment.

    The fused kernels keep two (vec_size, rhs) tiles in shared memory: the
    x-slice in the table dtype and the fp32 output tile the ER rows scatter
    into, so a row costs ``rhs · (dtype_bytes + 4)`` bytes of the budget;
    ``rhs`` is the number of right-hand-side columns one block holds at a
    time.  Callers read both constants from
    ``torch.cuda.get_device_properties``.
    """
    return choose_vec_size(n, rhs * (dtype_bytes + 4),
                           vmem_budget_bytes=smem_per_block,
                           p_units=sm_count, sublane=32)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _build_partition(n: int, n_parts: int, vec_size: int,
                     part_vec: np.ndarray) -> Partition:
    n_pad = n_parts * vec_size
    counts = np.bincount(part_vec, minlength=n_parts)
    if counts.max() > vec_size:
        raise ValueError("partition overflow: a part exceeds vec_size")
    # order vertices by (partition, original index); per-partition row-length
    # sorting (paper Algo 1 line 17) happens later in the EHYB builder since
    # it needs in-partition entry counts.
    order = np.lexsort((np.arange(n), part_vec))
    perm = np.full(n_pad, n_pad, dtype=np.int64)  # sentinel = n_pad ("padding")
    inv_perm = np.full(n_pad, -1, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    offsets = np.arange(n) - starts[part_vec[order]]
    slots = part_vec[order] * vec_size + offsets
    perm[slots] = order
    # padding slots point past the end; inv_perm for real vertices:
    inv_perm[order] = slots
    # give padding slots self-consistent inverse (old padded ids n..n_pad-1)
    pad_slots = np.flatnonzero(perm == n_pad)
    pad_ids = np.arange(n, n_pad, dtype=np.int64)
    perm[pad_slots] = pad_ids
    inv_perm[pad_ids] = pad_slots
    return Partition(n=n, n_pad=n_pad, n_parts=n_parts, vec_size=vec_size,
                     part_vec=part_vec.astype(np.int32), perm=perm,
                     inv_perm=inv_perm)


def _neighbor_stream(indptr: np.ndarray, indices: np.ndarray,
                     verts: np.ndarray) -> np.ndarray:
    """All neighbours of ``verts`` concatenated (duplicates kept) — one
    fancy-index gather, no per-vertex Python loop."""
    starts = indptr[verts].astype(np.int64)
    lens = (indptr[verts + 1] - indptr[verts]).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return indices[:0].astype(np.int64)
    shift = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return indices[shift + np.arange(total)].astype(np.int64)


def _induced_submatrix(m: SparseCSR, verts: np.ndarray) -> SparseCSR:
    """Renumbered CSR over ``verts``, keeping entries with both endpoints in
    the set (cross entries land in ER under any sub-partitioning, so the
    base strategy cannot affect them)."""
    local = np.full(m.n, -1, dtype=np.int64)
    local[verts] = np.arange(len(verts))
    rows = np.repeat(np.arange(m.n, dtype=np.int64), m.row_lengths())
    sel = (local[rows] >= 0) & (local[m.indices] >= 0)
    sub_r = local[rows[sel]]
    ns = len(verts)
    indptr = np.zeros(ns + 1, dtype=np.int64)
    np.cumsum(np.bincount(sub_r, minlength=ns), out=indptr[1:])
    return SparseCSR(n=ns, indptr=indptr,
                     indices=local[m.indices[sel]].astype(np.int32),
                     data=m.data[sel])


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

def natural_partition(m: SparseCSR, n_parts: int, vec_size: int) -> Partition:
    part_vec = np.minimum(np.arange(m.n) // vec_size, n_parts - 1)
    return _build_partition(m.n, n_parts, vec_size, part_vec.astype(np.int32))


def bfs_partition(m: SparseCSR, n_parts: int, vec_size: int,
                  refine_passes: int = 2, seed: int = 0) -> Partition:
    """Capacity-constrained BFS graph growing + greedy boundary refinement.

    The growth loop is vectorized: each round gathers the whole frontier's
    neighbour stream with one fancy-index (``_neighbor_stream``), dedupes
    with ``np.unique``, and assigns up to the remaining capacity — O(rounds)
    numpy calls per partition instead of the O(nnz) interpreted per-vertex
    loop the seed shipped with.
    """
    n = m.n
    indptr, indices = m.indptr, m.indices
    part_vec = np.full(n, -1, dtype=np.int32)
    degree = m.row_lengths()
    # visit vertices in peripheral order: seeds come from min-degree first
    heap = np.argsort(degree, kind="stable")
    heap_pos = 0
    for p in range(n_parts):
        while heap_pos < n and part_vec[heap[heap_pos]] >= 0:
            heap_pos += 1
        if heap_pos >= n:
            break
        frontier = heap[heap_pos:heap_pos + 1].astype(np.int64)
        part_vec[frontier] = p
        room = vec_size - 1
        while room > 0 and len(frontier):
            cand = np.unique(_neighbor_stream(indptr, indices, frontier))
            cand = cand[part_vec[cand] < 0]
            if len(cand) > room:
                cand = cand[:room]
            part_vec[cand] = p
            room -= len(cand)
            frontier = cand
        if room > 0:
            # BFS exhausted a connected component: fill from the heap
            rest = heap[heap_pos:]
            rest = rest[part_vec[rest] < 0][:room]
            part_vec[rest] = p
    # safety net (n < n_parts*vec_size corner): stragglers to parts with room
    leftovers = np.flatnonzero(part_vec < 0)
    if len(leftovers):
        sizes = np.bincount(part_vec[part_vec >= 0], minlength=n_parts)
        room = np.repeat(np.arange(n_parts), (vec_size - sizes).clip(min=0))
        part_vec[leftovers] = room[:len(leftovers)].astype(np.int32)

    part_vec = _refine(m, part_vec, n_parts, vec_size, refine_passes)
    return _build_partition(n, n_parts, vec_size, part_vec)


def _refine(m: SparseCSR, part_vec: np.ndarray, n_parts: int, vec_size: int,
            passes: int) -> np.ndarray:
    """Greedy gain-based boundary moves (FM-lite), strictly capacity-respecting.

    Per pass, each vertex's per-partition neighbour counts are accumulated
    SPARSELY over the (row, neighbour-partition) pairs actually present —
    O(nnz) time and memory, where the dense
    ``bincount(...).reshape(n, n_parts)`` histogram this replaces
    materialized an n×n_parts array per pass (ruinous for the web-graph
    matrices, where n_parts grows with n).  A vertex moves to the partition
    holding most of its neighbours only if that partition currently has
    room; moves are applied highest-gain first and there is no slack and no
    rebalancing pass — a full partition simply rejects further movers.
    """
    n = m.n
    if m.nnz == 0:
        return part_vec          # no neighbours, nothing to refine toward
    rows = np.repeat(np.arange(n), m.row_lengths())
    cols = m.indices.astype(np.int64)
    for _ in range(passes):
        # sparse histogram: one entry per (vertex, neighbour-partition) pair
        key = rows * n_parts + part_vec[cols]
        uniq, cnt = np.unique(key, return_counts=True)
        ur = uniq // n_parts
        up = (uniq % n_parts).astype(np.int32)
        # best partition per vertex: (row, -count, part) order → first row hit
        # is the max count with ties to the lowest partition id
        order = np.lexsort((up, -cnt, ur))
        first = np.concatenate([[True], ur[order][1:] != ur[order][:-1]])
        vtx = ur[order][first]
        best_at = up[order][first]
        best_cnt = cnt[order][first]
        cur_cnt = np.zeros(n, dtype=np.int64)
        here = up == part_vec[ur]
        cur_cnt[ur[here]] = cnt[here]
        best = part_vec.copy()
        gain = np.zeros(n, dtype=np.int64)
        best[vtx] = best_at
        gain[vtx] = best_cnt - cur_cnt[vtx]
        movers = np.flatnonzero((best != part_vec) & (gain > 0))
        if len(movers) == 0:
            break
        # capacity-respecting greedy: highest gain first
        movers = movers[np.argsort(-gain[movers], kind="stable")]
        sizes = np.bincount(part_vec, minlength=n_parts)
        for v in movers:
            b = best[v]
            if sizes[b] < vec_size:
                sizes[part_vec[v]] -= 1
                sizes[b] += 1
                part_vec[v] = b
    return part_vec


def mincut_partition(m: SparseCSR, n_parts: int, vec_size: int,
                     refine_passes: int = 2, fm_passes: int = 4,
                     seed: int = 0) -> Partition:
    """Recursive min-cut bisection over the column-net hypergraph model.

    Following the hypergraph-partitioning SpMV line (Akbudak, Kayaaslan &
    Aykanat 2012): every column is a net whose pins are the rows reading it
    plus the vertex owning its x-entry; a net spanning both sides of a
    bisection costs one extra word fetch (connectivity−1), which is exactly
    the quantity the EHYB ER path and the distributed halo pay.  Each level
    splits the vertex set with a BFS-locality seed split and FM-refines it
    under a capacity band, then recurses until every leaf maps to one
    partition.  A final k-way FM-lite polish (``_refine``) smooths leaf
    boundaries.
    """
    n = m.n
    rows = np.repeat(np.arange(n, dtype=np.int64), m.row_lengths())
    cols = m.indices.astype(np.int64)
    degree = m.row_lengths()
    part_vec = np.full(n, -1, dtype=np.int32)
    stack = [(np.arange(n, dtype=np.int64), 0, n_parts)]
    while stack:
        verts, lo, pc = stack.pop()
        if pc == 1 or len(verts) == 0:
            part_vec[verts] = lo
            continue
        p1 = pc // 2
        p2 = pc - p1
        ns = len(verts)
        # side-0 size band: both halves must fit their share of partitions
        lo0 = max(0, ns - p2 * vec_size)
        hi0 = min(p1 * vec_size, ns)
        target = min(max(int(round(ns * p1 / pc)), lo0), hi0)
        side = _bisect(m, verts, rows, cols, degree, target, lo0, hi0,
                       fm_passes)
        stack.append((verts[side == 0], lo, p1))
        stack.append((verts[side == 1], lo + p1, p2))
    part_vec = _refine(m, part_vec, n_parts, vec_size, refine_passes)
    return _build_partition(n, n_parts, vec_size, part_vec)


def _bfs_order(m: SparseCSR, verts: np.ndarray, degree: np.ndarray,
               in_set: np.ndarray) -> np.ndarray:
    """BFS-layer ordering of ``verts`` over the induced subgraph (locality
    order for the initial bisection split); components seeded min-degree
    first."""
    indptr, indices = m.indptr, m.indices
    visited = ~in_set
    order = np.empty(len(verts), dtype=np.int64)
    pos = 0
    seeds = verts[np.argsort(degree[verts], kind="stable")]
    sp = 0
    while pos < len(verts):
        while sp < len(seeds) and visited[seeds[sp]]:
            sp += 1
        if sp >= len(seeds):
            break
        frontier = seeds[sp:sp + 1].astype(np.int64)
        visited[frontier] = True
        order[pos] = frontier[0]
        pos += 1
        while len(frontier):
            nbrs = np.unique(_neighbor_stream(indptr, indices, frontier))
            nbrs = nbrs[~visited[nbrs]]
            if not len(nbrs):
                break
            visited[nbrs] = True
            order[pos:pos + len(nbrs)] = nbrs
            pos += len(nbrs)
            frontier = nbrs
    return order


def _bisect(m: SparseCSR, verts: np.ndarray, rows: np.ndarray,
            cols: np.ndarray, degree: np.ndarray, target: int, lo0: int,
            hi0: int, fm_passes: int) -> np.ndarray:
    """One capacity-banded bisection of ``verts``; returns side ∈ {0,1}.

    Seed split: BFS-locality order cut at ``target``.  Refinement: FM-style
    passes on column-net connectivity−1 gains, vectorized — each pass
    computes every vertex's gain from the per-net side counts, tentatively
    flips all positive-gain vertices (shedding the lowest-gain flips that
    would leave the capacity band), and keeps the flip only if the realized
    cut improved (monotone, so no FM rollback bookkeeping is needed).  Nets
    anchored outside ``verts`` are fixed by higher levels and excluded.
    """
    ns = len(verts)
    in_set = np.zeros(m.n, dtype=bool)
    in_set[verts] = True
    local = np.full(m.n, -1, dtype=np.int64)
    local[verts] = np.arange(ns)
    order = _bfs_order(m, verts, degree, in_set)
    side = np.ones(ns, dtype=np.int8)
    side[local[order[:target]]] = 0
    size0 = int(target)
    # column-net pins: in-subgraph entries (row reads column) + owner pins
    sel = in_set[rows] & in_set[cols]
    key = np.concatenate([local[rows[sel]] * ns + local[cols[sel]],
                          np.arange(ns) * ns + np.arange(ns)])
    key = np.unique(key)
    pin_v = key // ns
    pin_net = key % ns

    def cut_of(s: np.ndarray) -> tuple[int, np.ndarray]:
        cnt = np.bincount(pin_net * 2 + s[pin_v], minlength=2 * ns)
        return int(((cnt[0::2] > 0) & (cnt[1::2] > 0)).sum()), cnt

    cut, cnt = cut_of(side)
    for _ in range(fm_passes):
        s = side[pin_v]
        here = cnt[pin_net * 2 + s]
        there = cnt[pin_net * 2 + (1 - s)]
        w = (((here == 1) & (there > 0)).astype(np.int64)
             - (there == 0).astype(np.int64))
        gain = np.bincount(pin_v, weights=w, minlength=ns)
        movers = np.flatnonzero(gain > 0)
        if not len(movers):
            break
        movers = movers[np.argsort(-gain[movers], kind="stable")]
        d = np.where(side[movers] == 0, -1, 1)
        final0 = size0 + int(d.sum())
        accept = np.ones(len(movers), dtype=bool)
        if final0 < lo0:      # too many 0→1 flips: shed the lowest-gain ones
            accept[np.flatnonzero(d == -1)[::-1][:lo0 - final0]] = False
        elif final0 > hi0:    # too many 1→0 flips
            accept[np.flatnonzero(d == 1)[::-1][:final0 - hi0]] = False
        trial = side.copy()
        mv = movers[accept]
        trial[mv] = 1 - trial[mv]
        new_cut, new_cnt = cut_of(trial)
        if new_cut >= cut:
            break
        side, cnt, cut = trial, new_cnt, new_cut
        size0 += int(d[accept].sum())
    return side


def hub_partition(m: SparseCSR, n_parts: int, vec_size: int,
                  base: str = "bfs", hub_count: int | None = None,
                  degree_factor: float = 4.0, **base_kw) -> Partition:
    """Degree-sorted hub extraction for power-law matrices.

    High-degree "hub" vertices — the rows/columns the whole matrix touches —
    are pulled out and packed, in descending total-degree order, into
    dedicated partitions at the tail of the partition range; the remaining
    near-structured tail submatrix is partitioned by ``base`` (extra keyword
    arguments are forwarded to it).  Co-locating the hubs turns the dense
    hub↔hub core into in-partition (explicitly cached) entries, and each
    tail partition then routes only its few hub reads to ER instead of
    fragmenting its cache block across the hub columns.

    ``hub_count`` defaults to the number of vertices whose total degree
    (row nnz + column in-degree) exceeds ``degree_factor``× the mean, capped
    at half the partition capacity; the hub block absorbs extra vertices
    when its padding waste would otherwise overflow the global slack.
    """
    if base == "hub":
        raise ValueError("hub_partition cannot use itself as the base "
                         "strategy")
    n = m.n
    degree = m.row_lengths() + np.bincount(m.indices, minlength=n)
    if hub_count is None:
        hub_count = int((degree > degree_factor * max(float(degree.mean()),
                                                      1.0)).sum())
    hub_count = min(int(hub_count), (n_parts // 2) * vec_size, n)
    slack = n_parts * vec_size - n
    n_hub_parts = -(-hub_count // vec_size) if hub_count else 0
    # feasibility: padding wasted in a partially-filled hub partition eats
    # into the global padding slack; absorb more vertices into the hub block
    # until the tail is guaranteed to fit its remaining partitions.
    if n_hub_parts and n_hub_parts * vec_size - hub_count > slack:
        hub_count = min(n_hub_parts * vec_size - slack, n)
    if hub_count == 0:
        return _invoke(base, m, n_parts, vec_size, **base_kw)
    by_degree = np.argsort(-degree, kind="stable")
    hubs = by_degree[:hub_count]
    tail_parts = n_parts - n_hub_parts
    part_vec = np.full(n, -1, dtype=np.int32)
    part_vec[hubs] = (tail_parts
                      + np.arange(hub_count) // vec_size).astype(np.int32)
    tail = np.sort(by_degree[hub_count:])
    if len(tail):
        sub = _invoke(base, _induced_submatrix(m, tail), tail_parts,
                      vec_size, **base_kw)
        part_vec[tail] = sub.part_vec
    return _build_partition(n, n_parts, vec_size, part_vec)


# ---------------------------------------------------------------------------
# strategy registry + dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionStrategy:
    """Registry entry: ``fn(m, n_parts, vec_size, **kw) -> Partition``."""

    name: str
    fn: Callable[..., Partition]
    description: str = ""


_STRATEGIES: Dict[str, PartitionStrategy] = {}


def register_strategy(name: str, fn: Callable[..., Partition],
                      description: str = "") -> PartitionStrategy:
    spec = PartitionStrategy(name=name, fn=fn, description=description)
    _STRATEGIES[name] = spec
    return spec


def get_strategy(name: str) -> PartitionStrategy:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown partition method: {name!r} "
            f"(registered: {', '.join(available_strategies())})") from None


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(_STRATEGIES))


def _check_kwargs(spec: PartitionStrategy, kw: dict) -> None:
    sig = inspect.signature(spec.fn)
    params = list(sig.parameters.values())[3:]  # after (m, n_parts, vec_size)
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return  # forwarding strategy (e.g. hub → base) validates downstream
    names = {p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    unknown = sorted(set(kw) - names)
    if unknown:
        raise TypeError(
            f"partition strategy {spec.name!r} got unexpected keyword "
            f"argument(s) {unknown}; accepted: {sorted(names)}")


def _invoke(name: str, m: SparseCSR, n_parts: int, vec_size: int,
            **kw) -> Partition:
    spec = get_strategy(name)
    _check_kwargs(spec, kw)
    p = spec.fn(m, n_parts, vec_size, **kw)
    p.method = name
    return p


def make_partition(m: SparseCSR, method: str = "bfs",
                   dtype_bytes: int = 4, n_parts: int | None = None,
                   vec_size: int | None = None, **kw) -> Partition:
    """Build a :class:`Partition` with the registered strategy ``method``.

    Strategy kwargs are validated against the strategy's signature: an
    unknown keyword raises ``TypeError`` for *every* strategy (``natural``
    included), never a silent drop.  Wall-clock time lands in
    ``Partition.seconds`` (and from there in the EHYB builder's
    ``preprocess_seconds["partition"]``).
    """
    from .counters import bump

    bump("partition")
    if n_parts is None or vec_size is None:
        n_parts, vec_size = choose_vec_size(m.n, dtype_bytes)
    t0 = time.perf_counter()
    p = _invoke(method, m, n_parts, vec_size, **kw)
    p.seconds = time.perf_counter() - t0
    return p


register_strategy("natural", natural_partition,
                  "contiguous index blocks (stencil-optimal)")
register_strategy("bfs", bfs_partition,
                  "BFS graph growing + FM-lite boundary refinement")
register_strategy("mincut", mincut_partition,
                  "recursive column-net min-cut bisection (hypergraph model)")
register_strategy("hub", hub_partition,
                  "degree-sorted hub extraction over a base strategy")
