"""EHYB format construction (paper §3.2–3.4, Algorithms 1–2) — host side.

A numpy copy of ``repro.core.ehyb`` (the JAX package's builder, which the
port may not import): the same arrays, bit for bit, for the same partition
and ``vec_size``.  The Explicit-caching HYBrid format splits a partitioned,
symmetrically reordered sparse matrix into:

* a **sliced-ELL part** holding every entry whose column lies in the same
  partition as its row.  Column indices are stored *locally* (offset within
  the partition's x-slice) as ``uint16`` — the paper's §3.4 compact-index
  optimization.  Rows are sorted by in-partition length inside each
  partition (Algo 1 line 17–18), which tightens slices/tiles.
* an **ER ("extra rows") part** holding the out-of-partition remainder in a
  row-length-sorted padded layout with global column indices and an explicit
  row map ``er_row_idx`` (the paper's ``yIdxER``).

On Hopper the paper's own mapping holds: one partition per thread block, its
x-slice explicitly cached in shared memory (``repro_torch.kernels``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .counters import bump
from .matrices import SparseCSR
from .partition import Partition, make_partition


@dataclasses.dataclass
class EHYB:
    """EHYB matrix. All arrays are host numpy; ``core.spmv`` uploads them."""

    n: int                   # true dimension
    n_pad: int               # n_parts * vec_size
    n_parts: int
    vec_size: int
    # --- sliced-ELL (cached) part: uniform tiles -------------------------
    ell_width: int                    # W = max in-partition row width
    ell_vals: np.ndarray              # (n_parts, vec_size, W) float
    ell_cols: np.ndarray              # (n_parts, vec_size, W) uint16, LOCAL
    part_widths: np.ndarray           # (n_parts,) int32 — per-partition max width
    slice_widths: np.ndarray          # (n_parts, vec_size//sublane) int32 —
    # per 8-row-slice max width (the paper's sliced-ELL granularity; rows are
    # length-sorted inside each partition so slices are tight)
    # --- ER (uncached) part ----------------------------------------------
    er_rows: int                      # padded to sublane multiple (≥ 1 slice)
    er_width: int
    er_vals: np.ndarray               # (er_rows, er_width) float
    er_cols: np.ndarray               # (er_rows, er_width) int32, GLOBAL (new order)
    er_row_idx: np.ndarray            # (er_rows,) int32 — new-row of each ER slot
    # --- permutations ------------------------------------------------------
    perm: np.ndarray                  # (n_pad,) new slot -> old vertex (>=n: padding)
    inv_perm: np.ndarray              # (n_pad,) old (padded) vertex -> new slot
    # --- provenance / stats -------------------------------------------------
    nnz: int
    nnz_in: int                       # in-partition entries
    preprocess_seconds: dict = dataclasses.field(default_factory=dict)
    # --- value-refresh scatter plan --------------------------------------
    # ``ell_dst``/``er_dst``: flat destination indices into the (padded) ELL
    # and ER value tables; ``ell_src``/``er_src``: matching indices into the
    # CSR ``data`` stream; ``ell_widths``: (n_pad,) pattern row widths;
    # ``n_er_live``: live (pattern-bearing) ER slots.  Pattern-only — a new
    # value buffer on the same pattern replays the scatter with no
    # partitioning, reordering or sorting.
    fill_plan: Optional[dict] = None
    # registry name of the partition strategy that produced ``perm``
    partition_method: str = "bfs"

    # .....................................................................
    @property
    def in_part_fraction(self) -> float:
        return self.nnz_in / max(self.nnz, 1)

    @property
    def ell_padding_ratio(self) -> float:
        stored = self.n_parts * self.vec_size * self.ell_width
        return stored / max(self.nnz_in, 1)

    def bytes_moved(self, val_bytes: int = 4, col_bytes: int = 2,
                    layout: str = "sliced", space: str = "permuted",
                    fused_er: bool = True, k: int = 1) -> dict:
        """Modeled device-memory traffic of one SpMV (the paper's §3.4
        accounting; the same numbers as the JAX package's model).

        ELL streams vals + uint16 local cols once; every partition streams its
        x-slice into shared memory once (that is the explicit cache); ER
        streams vals +
        int32 cols + one random x-read per entry; y written once.

        layout: "sliced"  — the paper's sliced-ELL (per 8-row-slice widths;
                            padding only inside a slice),
                "tile"    — uniform (V, W) partition tiles (kernel v1),
                "packed"  — per-partition packed slices padded to the max
                            packed length across partitions (kernel v2).

        space: which vector space the caller hands x/y over in.
               "permuted" — the kernel-proper traffic (x and y already live in
               the EHYB-reordered space; this is what the paper's accounting
               measures and what the permuted-space solver loop pays per
               iteration);
               "original" — adds the per-call permutation round trip
               (``perm`` gather on x plus ``inv_perm`` gather on y:
               2·n_pad·val_bytes), the overhead a single original-space
               ``spmv()`` call cannot avoid.

        fused_er: ER contribution computed inside the main kernel (each
               partition owns its ER rows and scatters them into its own
               output tile) — the default, matching the shipped execution paths —
               vs a second launch with one random x-read per ER entry plus a
               caller-side scatter-add (2·er_rows·val_bytes of y
               read-modify-write), kept for the ablation.

        k: rhs batch width of a multi-rhs (SpMM) apply.  The A streams
               (ELL vals/cols, ER vals/cols/rows) are read ONCE regardless
               of k — that is the whole point of the explicit cache — while
               every x/y-sided term (x_cache, the ER x-gather, y, the
               permutation round trip) scales ×k.
        """
        if layout == "tile" or self.slice_widths is None:
            ell_n = self.n_parts * self.vec_size * self.ell_width
        elif layout == "sliced":
            ell_n = int(self.slice_widths.sum()) * 8
        else:  # packed
            per_part = self.slice_widths.sum(axis=1) * 8
            ell_n = int(per_part.max()) * self.n_parts
        ell = ell_n * (val_bytes + col_bytes)
        x_cache = self.n_pad * val_bytes * k
        er_n = self.er_rows * self.er_width
        has_er = bool(self.er_vals.any())
        if fused_er:
            # vals + cols stream once — at the PADDED per-partition tile
            # size (P, E, We) the fused kernel actually reads, not the flat
            # table (consistent with the ELL term, which also counts its
            # padding); the ER x-gather is bounded by n_pad; the scatter-add
            # disappears (each block accumulates its own ER rows into its
            # output tile).
            if has_er:
                g = group_er_by_partition(self)
                er_x = min(er_n, self.n_pad) * val_bytes * k
                er = (g["er_p_vals"].size * (val_bytes + 4) + er_x
                      + g["er_p_rows"].size * 4)
            else:
                er = 0      # ER stage skipped statically
        else:
            er = (er_n * (val_bytes + 4) + er_n * val_bytes * k
                  + self.er_rows * 4
                  + (2 * self.er_rows * val_bytes * k if has_er else 0))
        y = self.n_pad * val_bytes * k
        perm = 2 * self.n_pad * val_bytes * k if space == "original" else 0
        return {"ell": ell, "x_cache": x_cache, "er": er, "y": y,
                "perm": perm, "total": ell + x_cache + er + y + perm}

    def refill(self, new_data: np.ndarray) -> "EHYB":
        """Same sparsity pattern, new values: replay the build's scatters.

        Returns a new :class:`EHYB` sharing every structural array (columns,
        permutations, widths, the fill plan) with ``self``; only the value
        tables are rewritten, by one vectorized numpy scatter each — no
        partitioning, reordering or sorting.  The views memoized on
        ``self`` (the ER grouping, the compact ER stream, the packed
        staircase, the width buckets) come along refilled (:func:`carry_views`), so that no
        later step redoes their pass.

        ``new_data`` is the CSR ``data`` stream of a matrix with the
        *identical* pattern; callers key on ``pattern_hash`` to guarantee
        that."""
        if self.fill_plan is None:
            raise ValueError("this EHYB carries no fill plan; rebuild "
                             "instead")
        new_data = np.asarray(new_data)
        if new_data.shape != (self.nnz,):
            raise ValueError(f"value buffer has {new_data.shape} entries; "
                             f"pattern holds {self.nnz}")
        bump("ehyb_refill")
        t0 = time.perf_counter()
        plan = self.fill_plan
        ell = np.zeros(self.n_pad * self.ell_width, dtype=np.float64)
        ell[plan["ell_dst"]] = new_data[plan["ell_src"]]
        ell = ell.reshape(self.n_parts, self.vec_size, self.ell_width)
        er = np.zeros(self.er_rows * self.er_width, dtype=np.float64)
        er[plan["er_dst"]] = new_data[plan["er_src"]]
        er = er.reshape(self.er_rows, self.er_width)
        new = dataclasses.replace(self, ell_vals=ell, er_vals=er,
                                  preprocess_seconds={})
        carry_views(self, new)
        dt = time.perf_counter() - t0
        # structure passes cost exactly zero on a refill
        new.preprocess_seconds = {"partition": 0.0, "metadata": 0.0,
                                  "reorder": 0.0, "refill": dt, "total": dt}
        return new


def carry_views(old: EHYB, new: EHYB) -> None:
    """Give ``new`` (a build of ``old``'s pattern with other values, as
    :meth:`EHYB.refill` makes) each view memoized on ``old`` that it lacks,
    with ``new``'s values: the ER grouping, its tiles refilled through the
    recorded ``own``/``slot``/``src``; the compact ER stream, pattern-only,
    the same object; the packed staircase, through ``PackedEHYB.refill``;
    the width buckets at each bucket count (``_buckets`` for the default
    count, ``_buckets_nb`` for others), through ``EHYBBuckets.refill``.
    No view's structure pass runs again."""
    g = getattr(old, "_er_grouped", None)
    if g is not None and getattr(new, "_er_grouped", None) is None:
        gp = np.zeros_like(g["er_p_vals"])
        gp[g["own"], g["slot"]] = new.er_vals[g["src"]]
        new._er_grouped = {**g, "er_p_vals": gp}
    s = getattr(old, "_er_stream", None)
    if s is not None and getattr(new, "_er_stream", None) is None:
        new._er_stream = s
    pk = getattr(old, "_packed", None)
    if pk is not None and getattr(new, "_packed", None) is None:
        new._packed = pk.refill(new)
    b = getattr(old, "_buckets", None)
    if b is not None and getattr(new, "_buckets", None) is None:
        new._buckets = b.refill(new)
    nb = getattr(old, "_buckets_nb", None)
    if nb is not None and getattr(new, "_buckets_nb", None) is None:
        new._buckets_nb = {count: bb.refill(new) for count, bb in nb.items()}


def build_ehyb(m: SparseCSR, part: Optional[Partition] = None,
               method: str = "bfs", dtype_bytes: int = 4,
               sublane: int = 8, max_width: Optional[int] = None,
               **part_kw) -> EHYB:
    """Algorithms 1–2 of the paper, vectorized with numpy.

    ``max_width`` (beyond-paper knob, default off) caps the sliced-ELL width
    and spills over-long in-partition rows to the ER part — a robustness valve
    for power-law matrices.
    """
    bump("build_ehyb")
    t0 = time.perf_counter()
    if part is None:
        part = make_partition(m, method=method, dtype_bytes=dtype_bytes,
                              **part_kw)
    # a prebuilt `part` (e.g. the autotuned winner) carries its own timing
    t_part = max(time.perf_counter() - t0, getattr(part, "seconds", 0.0))

    t0 = time.perf_counter()
    n, n_parts, V = m.n, part.n_parts, part.vec_size
    n_pad = part.n_pad
    rows = np.repeat(np.arange(n, dtype=np.int64), m.row_lengths())
    cols = m.indices.astype(np.int64)
    vals = m.data
    same = part.part_vec[rows] == part.part_vec[cols]

    # ---- per-row in-partition counts drive the within-partition sort
    # (Algo 1 lines 3–18) --------------------------------------------------
    in_counts = np.bincount(rows[same], minlength=n)
    # current slots from the partition (grouped by partition, orig order)
    base_slot = part.inv_perm[:n]
    part_of = base_slot // V
    # sort within each partition by (-in_count, orig index) — stable & exact
    order = np.lexsort((np.arange(n), -in_counts, part_of))
    # `order` lists vertices partition-major; rebuild slots with row-sort
    slot_rank = np.empty(n, dtype=np.int64)
    counts_per_part = np.bincount(part_of, minlength=n_parts)
    starts = np.concatenate([[0], np.cumsum(counts_per_part)])
    slot_rank[order] = np.arange(n) - starts[part_of[order]]
    inv_perm = np.full(n_pad, -1, dtype=np.int64)
    inv_perm[:n] = part_of * V + slot_rank
    # padding vertices fill remaining slots of each partition
    all_slots = np.zeros(n_pad, dtype=bool)
    all_slots[inv_perm[:n]] = True
    free_slots = np.flatnonzero(~all_slots)
    inv_perm[n:] = free_slots
    perm = np.empty(n_pad, dtype=np.int64)
    perm[inv_perm] = np.arange(n_pad)

    new_r = inv_perm[rows]
    new_c = inv_perm[cols]

    # ---- split in-partition / ER, with optional width cap -----------------
    in_mask = same.copy()
    if max_width is not None:
        # spill entries beyond max_width per row (keep smallest local cols)
        ord_in = np.lexsort((new_c, new_r))
        rr = new_r[ord_in][same[ord_in]]
        # rank of each in-part entry within its row
        idx_in = ord_in[same[ord_in]]
        row_change = np.concatenate([[True], rr[1:] != rr[:-1]])
        grp_start = np.maximum.accumulate(np.where(row_change,
                                                   np.arange(len(rr)), 0))
        rank = np.arange(len(rr)) - grp_start
        spill = idx_in[rank >= max_width]
        in_mask[spill] = False

    t_reorder0 = time.perf_counter()

    # ---- fill sliced-ELL (Algo 2, lines 4–8) ------------------------------
    sel = np.flatnonzero(in_mask)
    order_in = sel[np.lexsort((new_c[sel], new_r[sel]))]
    r_in = new_r[order_in]
    widths = np.bincount(r_in, minlength=n_pad)
    W = int(widths.max()) if len(r_in) else 1
    W = max(W, 1)
    part_widths = widths.reshape(n_parts, V).max(axis=1).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(widths)])
    k = np.arange(len(r_in)) - row_start[r_in]
    ell_vals = np.zeros((n_pad, W), dtype=np.float64)
    ell_cols = np.zeros((n_pad, W), dtype=np.uint16)
    ell_vals[r_in, k] = vals[order_in]
    local = (new_c[order_in] - (r_in // V) * V)
    if V > (1 << 16):
        raise ValueError("vec_size exceeds uint16 local index range")
    ell_cols[r_in, k] = local.astype(np.uint16)
    ell_vals = ell_vals.reshape(n_parts, V, W)
    ell_cols = ell_cols.reshape(n_parts, V, W)
    # per 8-row-slice widths (paper's sliced-ELL accounting granularity)
    slice_widths = widths.reshape(n_parts, V // sublane, sublane).max(
        axis=2).astype(np.int32) if V % sublane == 0 else None

    # ---- fill ER (Algo 2, lines 10–13; Algo 1 lines 16, 23–26) ------------
    sel_er = np.flatnonzero(~in_mask)
    er_counts = np.bincount(new_r[sel_er], minlength=n_pad)
    er_rows_idx = np.flatnonzero(er_counts)
    # global sort by descending out-count (Algo 1 line 16)
    er_rows_idx = er_rows_idx[np.argsort(-er_counts[er_rows_idx],
                                         kind="stable")]
    n_er = len(er_rows_idx)
    n_er_pad = max(sublane, -(-max(n_er, 1) // sublane) * sublane)
    er_width = int(er_counts.max()) if n_er else 1
    er_vals = np.zeros((n_er_pad, er_width), dtype=np.float64)
    er_cols = np.zeros((n_er_pad, er_width), dtype=np.int32)
    er_row_idx = np.zeros(n_er_pad, dtype=np.int32)
    er_dst = np.empty(0, dtype=np.int64)
    er_src = np.empty(0, dtype=np.int64)
    if n_er:
        er_row_idx[:n_er] = er_rows_idx
        er_slot = np.full(n_pad, -1, dtype=np.int64)
        er_slot[er_rows_idx] = np.arange(n_er)
        order_er = sel_er[np.lexsort((new_c[sel_er], new_r[sel_er]))]
        r_er = new_r[order_er]
        rs = np.concatenate([[0], np.cumsum(np.bincount(r_er, minlength=n_pad))])
        kk = np.arange(len(r_er)) - rs[r_er]
        er_vals[er_slot[r_er], kk] = vals[order_er]
        er_cols[er_slot[r_er], kk] = new_c[order_er].astype(np.int32)
        er_dst = er_slot[r_er] * er_width + kk
        er_src = order_er
    t_reorder = time.perf_counter() - t_reorder0
    t_meta = t_reorder0 - t0

    # value-refresh plan: the two scatters above, recorded as flat indices
    # (``refill`` replays them on a new value buffer with zero structure work)
    fill_plan = {"ell_dst": r_in * W + k, "ell_src": order_in,
                 "er_dst": er_dst, "er_src": er_src,
                 "ell_widths": widths.astype(np.int32),
                 "n_er_live": n_er}

    return EHYB(n=n, n_pad=n_pad, n_parts=n_parts, vec_size=V,
                ell_width=W, ell_vals=ell_vals, ell_cols=ell_cols,
                part_widths=part_widths, slice_widths=slice_widths,
                er_rows=n_er_pad, er_width=er_width, er_vals=er_vals,
                er_cols=er_cols, er_row_idx=er_row_idx,
                perm=perm, inv_perm=inv_perm,
                nnz=m.nnz, nnz_in=int(in_mask.sum()),
                preprocess_seconds={"partition": t_part, "metadata": t_meta,
                                    "reorder": t_reorder,
                                    "total": t_part + t_meta + t_reorder},
                fill_plan=fill_plan,
                partition_method=getattr(part, "method", "") or method)


# ---------------------------------------------------------------------------
# ER-by-partition grouping (fused-megakernel metadata)
# ---------------------------------------------------------------------------

def group_er_by_partition(e: EHYB, sublane: int = 8) -> dict:
    """Map every ER slot to its owning partition (``er_row_idx // vec_size``).

    The fused EHYB kernel runs one thread block per partition; giving block
    ``p`` its own ER rows lets it accumulate them into the same (V,) output
    tile as the sliced-ELL part — no second launch, no caller-side
    scatter-add.  Returns uniform (P, E, We) tiles (E = max ER rows owned by
    any partition, sublane-aligned; empty slots hold zero values and row 0,
    which contribute nothing — but several of them share row 0, so a GPU
    scatter of the slots into the tile must be atomic):

      ``er_p_vals``  (P, E, We) float
      ``er_p_cols``  (P, E, We) int32 global-new column indices
      ``er_p_rows``  (P, E)     int32 LOCAL row index within the partition

    The result is memoized on ``e`` so the device builders (uniform + packed)
    and the bytes model share one grouping pass.
    """
    cached = getattr(e, "_er_grouped", None)
    if cached is not None and cached["sublane"] == sublane:
        return cached
    bump("group_er")
    p_, v_, we = e.n_parts, e.vec_size, e.er_width
    if e.fill_plan is not None:
        # pattern-derived live set: ER slots [0, n_er) hold the live rows by
        # construction (value-independent — explicit zeros stay live, so a
        # later ``refill`` can never change the grouping)
        live = np.arange(e.fill_plan["n_er_live"])
    else:
        live = np.flatnonzero((e.er_vals != 0).any(axis=1))
    owner = e.er_row_idx[live] // v_
    counts = np.bincount(owner, minlength=p_) if len(live) else \
        np.zeros(p_, dtype=np.int64)
    em = int(counts.max()) if len(live) else 0
    ep = max(sublane, -(-max(em, 1) // sublane) * sublane)
    er_p_vals = np.zeros((p_, ep, we), dtype=e.er_vals.dtype)
    er_p_cols = np.zeros((p_, ep, we), dtype=np.int32)
    er_p_rows = np.zeros((p_, ep), dtype=np.int32)
    own = np.empty(0, dtype=np.int64)
    slot = np.empty(0, dtype=np.int64)
    src = np.empty(0, dtype=np.int64)
    if len(live):
        order = np.argsort(owner, kind="stable")
        src = live[order]
        own = owner[order]
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(src)) - starts[own]
        er_p_vals[own, slot] = e.er_vals[src]
        er_p_cols[own, slot] = e.er_cols[src]
        er_p_rows[own, slot] = (e.er_row_idx[src] % v_).astype(np.int32)
    out = {"er_p_vals": er_p_vals, "er_p_cols": er_p_cols,
           "er_p_rows": er_p_rows, "has_er": bool(len(live)),
           "n_er_live": int(len(live)), "sublane": sublane,
           # refill plan: er_p_vals[own, slot] = er_vals_new[src]
           "own": own, "slot": slot, "src": src}
    e._er_grouped = out
    return out


def er_stream(e: EHYB) -> dict:
    """The live ER entries alone, grouped by owning partition: the compact
    stream the CUDA SpMV kernels read in place of the padded ``er_p_*``
    tiles (a device layout of the same operator; the port's own, the JAX
    package has no counterpart).

    Laid out from the pattern — ``e.fill_plan["er_dst"]`` and the grouping's
    ``own``/``slot``/``src`` — never from the values, so a stored zero keeps
    its entry and the layout holds for every bind of the pattern.  The
    partitions' rows come in the grouping's order, which is descending
    length (the build sorts ER rows by descending count, the grouping is a
    stable sort by owner), and each row's entries in column order, so the
    stream is the live slots of ``er_p_*`` read in row-major order:

      ``part_ptr`` (P+1,)       int32 — partition p's rows are
                                        ``[part_ptr[p], part_ptr[p+1])``
      ``row_ptr``  (Rlive+1,)   int32 — row r's entries are
                                        ``[row_ptr[r], row_ptr[r+1])``
      ``rows``     (Rlive,)     int32 — row r's LOCAL row in its partition
      ``pos``      (nnz_er,)    int64 — each entry's flat position in the
                                        ``(P, E, We)`` tiles, to gather the
                                        values and columns from them
      ``tile_shape``            (P, E, We) of the tiles ``pos`` indexes

    Raises if two live ER rows of a partition share a local row: the
    kernels add each row's sum into the block's tile with a plain add.
    Memoized on ``e``."""
    cached = getattr(e, "_er_stream", None)
    if cached is not None:
        return cached
    if e.fill_plan is None:
        raise ValueError("the compact ER stream is laid out from the "
                         "pattern: the build has no fill_plan")
    g = group_er_by_partition(e)
    p_, v_, we = e.n_parts, e.vec_size, e.er_width
    ep = g["er_p_vals"].shape[1]
    own, slot, src = g["own"], g["slot"], g["src"]
    slot_len = np.bincount(e.fill_plan["er_dst"] // we,
                           minlength=e.er_rows)
    row_len = slot_len[src]
    rows = g["er_p_rows"][own, slot]
    if len(np.unique(own * v_ + rows)) != len(rows):
        raise ValueError("two live ER rows of a partition share a local row")
    part_ptr = np.zeros(p_ + 1, dtype=np.int64)
    part_ptr[1:] = np.cumsum(np.bincount(own, minlength=p_))
    row_ptr = np.zeros(len(src) + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(row_len)
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError("the ER stream exceeds int32 offsets")
    # entry j of row r sits at slot (own[r], slot[r]), position j - row_ptr[r]
    pos = (np.repeat((own * ep + slot) * we - row_ptr[:-1], row_len)
           + np.arange(row_ptr[-1]))
    out = {"part_ptr": part_ptr.astype(np.int32),
           "row_ptr": row_ptr.astype(np.int32),
           "rows": rows.astype(np.int32), "pos": pos,
           "tile_shape": tuple(g["er_p_vals"].shape)}
    e._er_stream = out
    return out


# ---------------------------------------------------------------------------
# packed "staircase" layout (kernel v2 — beyond-paper §Perf optimization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedEHYB:
    """Column-major staircase packing of the sliced-ELL part.

    Within a partition, rows are width-sorted (paper Algo 1 l.17), so the
    active cells of column k form a PREFIX of rows [0, R_k).  Storing columns
    contiguously (vals/cols of column k at ``col_starts[p,k]``) eliminates
    inter-slice padding: HBM bytes ≈ the paper's sliced-ELL accounting,
    while the kernel keeps static-shape vector loads (dynamic offset, fixed
    V-length, masked by R_k).
    """

    base: EHYB
    packed_len: int                   # L (max over partitions, + V guard)
    packed_vals: np.ndarray           # (P, L) float
    packed_cols: np.ndarray           # (P, L) uint16
    col_starts: np.ndarray            # (P, W+1) int32 — column k offset
    col_rows: np.ndarray              # (P, W) int32 — active rows R_k
    pack_plan: Optional[dict] = None  # (pi, vi, ki) -> (pi, dest) scatter

    def refill(self, base: EHYB) -> "PackedEHYB":
        """Re-pack from ``base`` (a value-refilled EHYB on the same pattern)
        by replaying the recorded scatter — no width recomputation."""
        if self.pack_plan is None:
            raise ValueError("this PackedEHYB carries no pack plan")
        p = self.pack_plan
        packed_vals = np.zeros_like(self.packed_vals)
        packed_vals[p["pi"], p["dest"]] = base.ell_vals[p["pi"], p["vi"],
                                                        p["ki"]]
        return dataclasses.replace(self, base=base, packed_vals=packed_vals)

    def bytes_moved(self, val_bytes: int = 4, col_bytes: int = 2,
                    space: str = "permuted", fused_er: bool = True,
                    k: int = 1) -> dict:
        b = self.base.bytes_moved(val_bytes, col_bytes, layout="sliced",
                                  space=space, fused_er=fused_er, k=k)
        ell = self.base.n_parts * self.packed_len * (val_bytes + col_bytes)
        return {**b, "ell": ell,
                "total": ell + b["x_cache"] + b["er"] + b["y"] + b["perm"]}


def pack_staircase(e: EHYB) -> PackedEHYB:
    """Pack the (P, V, W) tiles column-major with no inter-slice padding.

    Vectorized as one numpy scatter: cell (p, v, k) is active when
    ``v < col_rows[p, k]`` (rows are width-sorted, so column k's active rows
    are the prefix [0, R_k)), and its destination within partition p's packed
    stream is ``col_starts[p, k] + v``.  The previous O(P·W) Python fill loop
    dominated preprocessing on large matrices; the scatter is recorded in
    ``preprocess_seconds["pack"]``.
    """
    bump("pack_staircase")
    t0 = time.perf_counter()
    p_, v_, w_ = e.n_parts, e.vec_size, e.ell_width
    if e.fill_plan is not None:
        # pattern widths (value-independent: explicit zeros stay packed, so
        # the recorded scatter stays valid for new values on the pattern)
        widths = e.fill_plan["ell_widths"].reshape(p_, v_)
    else:
        widths = (e.ell_vals != 0).sum(axis=2)           # (P, V) row widths
    # R_k per partition: number of rows with width > k (rows are sorted)
    ks = np.arange(w_)[None, None, :]
    col_rows = (widths[:, :, None] > ks).sum(axis=1).astype(np.int32)  # (P,W)
    lens = col_rows.sum(axis=1)
    pack_l = int(lens.max()) + v_                        # + V over-read guard
    packed_vals = np.zeros((p_, pack_l), dtype=e.ell_vals.dtype)
    packed_cols = np.zeros((p_, pack_l), dtype=np.uint16)
    col_starts = np.zeros((p_, w_ + 1), dtype=np.int32)
    col_starts[:, 1:] = np.cumsum(col_rows, axis=1)
    active = np.arange(v_)[None, :, None] < col_rows[:, None, :]  # (P, V, W)
    pi, vi, ki = np.nonzero(active)
    dest = col_starts[pi, ki] + vi
    packed_vals[pi, dest] = e.ell_vals[pi, vi, ki]
    packed_cols[pi, dest] = e.ell_cols[pi, vi, ki]
    e.preprocess_seconds["pack"] = time.perf_counter() - t0
    return PackedEHYB(base=e, packed_len=pack_l, packed_vals=packed_vals,
                      packed_cols=packed_cols, col_starts=col_starts,
                      col_rows=col_rows,
                      pack_plan={"pi": pi, "dest": dest, "vi": vi, "ki": ki})


# ---------------------------------------------------------------------------
# width-bucketed variant (beyond-paper §Perf optimization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class EHYBBuckets:
    """Partitions grouped into width buckets — one uniform tile per bucket.

    The baseline format pads every partition tile to the *global* max width
    W; on matrices with variable partition density this wastes HBM bytes.
    Grouping partitions into a few width classes, one uniform tile each,
    removes most of that padding (the JAX package's ``EHYBBuckets``; the
    same arrays, bit for bit)."""

    base: EHYB
    part_ids: list        # list[np.ndarray (B,) int32]
    vals: list            # list[np.ndarray (B, V, Wb)]
    cols: list            # list[np.ndarray (B, V, Wb) uint16]
    widths: list          # list[int]

    def refill(self, base: EHYB) -> "EHYBBuckets":
        """The buckets of ``base`` (a value-refilled EHYB on the same
        pattern): each bucket's tiles re-sliced from ``base.ell_vals``, the
        grouping and columns shared."""
        return EHYBBuckets(
            base=base, part_ids=self.part_ids,
            vals=[np.ascontiguousarray(base.ell_vals[ch, :, : v.shape[2]])
                  for ch, v in zip(self.part_ids, self.vals)],
            cols=self.cols, widths=self.widths)

    def bytes_moved(self, val_bytes: int = 4, col_bytes: int = 2,
                    space: str = "permuted", fused_er: bool = True,
                    k: int = 1) -> dict:
        ell = sum(v.size * (val_bytes + col_bytes) for v in self.vals)
        base = self.base.bytes_moved(val_bytes, col_bytes, space=space,
                                     fused_er=fused_er, k=k)
        return {**base, "ell": ell,
                "total": ell + base["x_cache"] + base["er"] + base["y"]
                + base["perm"]}


def build_buckets(e: EHYB, n_buckets: int = 4, lane: int = 8) -> EHYBBuckets:
    """Group partitions by width into ≤ n_buckets classes (equal-count split,
    widths lane-aligned)."""
    bump("build_buckets")
    order = np.argsort(e.part_widths, kind="stable")
    chunks = np.array_split(order, n_buckets)
    part_ids, vals, cols, widths = [], [], [], []
    for ch in chunks:
        if len(ch) == 0:
            continue
        wb = int(e.part_widths[ch].max())
        wb = max(lane, -(-wb // lane) * lane)
        wb = min(wb, e.ell_width)
        part_ids.append(ch.astype(np.int32))
        vals.append(np.ascontiguousarray(e.ell_vals[ch, :, :wb]))
        cols.append(np.ascontiguousarray(e.ell_cols[ch, :, :wb]))
        widths.append(wb)
    return EHYBBuckets(base=e, part_ids=part_ids, vals=vals, cols=cols,
                       widths=widths)
