"""Halo-exchange planning: the compact column index, lifted to the mesh.

The port of ``repro.dist.halo``, host numpy like the reference's: every
array of a :class:`HaloPlan` is bit-identical to the JAX package's for the
same ``EHYB`` and ``n_dev``.  :func:`fetch_layout` adds the device layout of
one rank's fetch-side ER table that the ER kernel (#6) reads.

The EHYB format already splits the matrix so that in-partition entries read
x through a compact local index and only the ER remainder references far
columns.  Distributing over ``n_dev`` devices (``parts_per_dev`` partitions
each) makes the device's x shard the explicitly cached slice; the only
per-iteration communication is the x values (or partial-y sums) the ER
entries reference across device boundaries.  This module precomputes that
exchange once per sparsity pattern.

For every ordered device pair (d reads from s) the plan picks the cheaper
of two directions, both exact:

* **x-fetch** — s sends the *sorted unique* columns of its shard that d's
  ER entries reference (``u_cols`` words).  d renumbers those entries'
  columns into the compact local space ``[0, local_size + halo)`` — the
  mesh-level analogue of the paper's §3.4 uint16 local index.
* **y-push** — s computes the partial products of the A[d, s] block against
  its own shard (columns are *local* to s) and sends one partial sum per
  distinct destination row (``u_rows`` words); d scatter-adds them.  This
  wins exactly where x-fetch saturates: power-law hub rows that touch most
  of a remote shard.

All segments ride one ``all_to_all`` per SpMV with a uniform segment length
``seg_len`` (the max over pairs); padding slots are masked to zero and never
read.  The plan is **pattern-only** — built from ``EHYB.fill_plan``'s live
entry set, never from entry values — so value refills
(``ShardedOperator.update_values``) replay the recorded fill maps with zero
re-planning, the same contract as the single-device scatter plans.

Word accounting (single rhs column; multiply by R for SpMM):

* ``halo_words``       — Σ over pairs of the scheduled payload (the compact
                         exchange this plan actually needs);
* ``buffer_words``     — mesh-wide padded ``all_to_all`` payload,
                         ``n_dev² · seg_len`` (what the collective carries);
* ``allgather_words``  — what the replaced implementation moved per
                         iteration: a full x all-gather plus a full-length
                         psum-scatter of the ER remainder, ``2 · n_dev ·
                         n_pad`` (see ``repro_torch.dist.allgather``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.counters import bump
from ..core.ehyb import EHYB

_FETCH, _PUSH = 1, 2


@dataclasses.dataclass
class HaloPlan:
    """Precomputed exchange schedule + compact-index ER tables (host numpy).

    Shapes are uniform across devices (leading ``n_dev`` axis, per-device
    padding masked); every array is a pure function of the sparsity pattern.
    """

    # --- mesh geometry ----------------------------------------------------
    n_dev: int
    parts_per_dev: int
    n_parts_pad: int          # n_dev * parts_per_dev (>= n_parts: padding)
    local_size: int           # parts_per_dev * vec_size
    n_pad_dist: int           # n_dev * local_size (>= EHYB.n_pad)
    n_pad: int                # the EHYB padded dimension the plan was built on
    # --- exchange schedule -------------------------------------------------
    seg_len: int              # S: uniform all_to_all segment length
    halo_len: int             # H: max fetched-halo length over devices
    direction: np.ndarray     # (n_dev, n_dev) int8: 0 none / 1 fetch / 2 push
    counts_fetch: np.ndarray  # (n_dev, n_dev) words d fetches from s
    counts_push: np.ndarray   # (n_dev, n_dev) words s pushes to d
    send_idx: np.ndarray      # (n_dev, n_dev, S) int32 local x idx per source
    send_mask: np.ndarray     # (n_dev, n_dev, S) bool valid fetch slots
    recv_sel: np.ndarray      # (n_dev, H) int32 flat idx into (n_dev*S) recv
    # --- push-side (partial-y) entries, grouped by source device ----------
    pe_cols: np.ndarray       # (n_dev, PE) int32 column local to the source
    pe_dst: np.ndarray        # (n_dev, PE) int32 flat slot into (n_dev*S)
    pe_mask: np.ndarray       # (n_dev, PE) bool
    pe_src: np.ndarray        # (n_dev, PE) int64 flat idx into the ER table
    # --- push-side receive: partial sums into local rows -------------------
    rp_sel: np.ndarray        # (n_dev, PR) int32 flat idx into (n_dev*S) recv
    rp_rows: np.ndarray       # (n_dev, PR) int32 local destination row
    rp_mask: np.ndarray       # (n_dev, PR) bool
    # --- fetch-side ER tables (computed on the row owner) ------------------
    fer_cols: np.ndarray      # (n_dev, Rf, Wf) int32 COMPACT local columns
    fer_rows: np.ndarray      # (n_dev, Rf) int32 local destination row
    fer_dst: np.ndarray       # (F,) int64 flat idx into the fer value table
    fer_src: np.ndarray       # (F,) int64 flat idx into the ER value table
    # --- static flags / accounting -----------------------------------------
    has_er: bool
    needs_comm: bool
    has_push: bool
    halo_words: int
    buffer_words: int
    allgather_words: int
    per_device_words: np.ndarray   # (n_dev,) words each device receives

    # ---- value fills (replayed per refill; pattern arrays never change) ---
    def fill_fetch(self, er_vals: np.ndarray) -> np.ndarray:
        """(n_dev, Rf, Wf) fetch-table values from the flat ER value table."""
        out = np.zeros(self.fer_cols.shape, dtype=np.float64)
        out.reshape(-1)[self.fer_dst] = er_vals.reshape(-1)[self.fer_src]
        return out

    def fill_push(self, er_vals: np.ndarray) -> np.ndarray:
        """(n_dev, PE) push-entry values from the flat ER value table."""
        flat = er_vals.reshape(-1)
        out = np.where(self.pe_mask, flat[self.pe_src], 0.0)
        return out.astype(np.float64)


def _live_entries(e: EHYB):
    """Flat (rows, cols, src) of the live ER entries.

    Prefers the pattern-derived live set recorded at build time
    (``fill_plan`` — value-independent, so explicit zeros stay live and a
    later refill can never change the plan); containers predating the fill
    plan fall back to the nonzero mask."""
    if e.fill_plan is not None:
        src = np.asarray(e.fill_plan["er_dst"], dtype=np.int64)
    else:
        src = np.flatnonzero(np.asarray(e.er_vals).reshape(-1) != 0)
    slots = src // e.er_width
    rows = np.asarray(e.er_row_idx, dtype=np.int64)[slots]
    cols = np.asarray(e.er_cols, dtype=np.int64).reshape(-1)[src]
    return rows, cols, src


def _pair_unique_counts(rows, cols, own_r, own_c, n_dev, key_span):
    """(u_cols, u_rows): per ordered pair (row-owner, col-owner), the number
    of distinct columns / distinct rows among its cross-device entries."""
    off = own_r != own_c
    pair = (own_r[off] * n_dev + own_c[off]).astype(np.int64)
    u_cols = np.bincount(
        np.unique(pair * key_span + cols[off]) // key_span,
        minlength=n_dev * n_dev).reshape(n_dev, n_dev)
    u_rows = np.bincount(
        np.unique(pair * key_span + rows[off]) // key_span,
        minlength=n_dev * n_dev).reshape(n_dev, n_dev)
    return u_cols, u_rows


def ehyb_halo_words(e: EHYB, n_dev: int) -> int:
    """Scheduled per-iteration exchange words of ``e`` over ``n_dev`` devices
    (Σ over pairs of min(unique columns, unique rows) — the §3.4-style
    interconnect term the ``context="dist"`` cost model ranks on).  Memoized
    on the host build; cheap relative to :func:`build_halo_plan`."""
    cache = getattr(e, "_halo_words", None)
    if cache is None:
        cache = e._halo_words = {}
    if n_dev not in cache:
        rows, cols, _ = _live_entries(e)
        ppd = -(-e.n_parts // n_dev)
        L = ppd * e.vec_size
        u_cols, u_rows = _pair_unique_counts(
            rows, cols, rows // L, cols // L, n_dev, n_dev * L)
        cache[n_dev] = int(np.minimum(u_cols, u_rows).sum())
    return cache[n_dev]


def partition_halo_words(m, part, n_dev: int) -> int:
    """Scheduled exchange words a
    :class:`~repro_torch.core.partition.Partition` would cost
    over ``n_dev`` devices — priced from the pattern + partition alone,
    before any EHYB build.

    Device ownership follows the halo plan's round-robin partition blocks
    (``part_id // ceil(n_parts/n_dev)``); the cross-device entries are
    exactly the out-of-partition (ER) entries whose endpoints land on
    different devices, and each ordered pair exchanges
    min(unique columns, unique rows) — identical to
    :func:`ehyb_halo_words` on the built container (pinned by tests), which
    is how ``autotune_partition`` ranks strategies for ``context="dist"``.
    """
    rows = np.repeat(np.arange(m.n, dtype=np.int64), m.row_lengths())
    cols = m.indices.astype(np.int64)
    pv = part.part_vec.astype(np.int64)
    er = pv[rows] != pv[cols]
    rows, cols = rows[er], cols[er]
    ppd = -(-part.n_parts // n_dev)
    u_cols, u_rows = _pair_unique_counts(rows, cols, pv[rows] // ppd,
                                         pv[cols] // ppd, n_dev, part.n_pad)
    return int(np.minimum(u_cols, u_rows).sum())


def build_halo_plan(e: EHYB, n_dev: int, sublane: int = 8) -> HaloPlan:
    """Compute the :class:`HaloPlan` for ``e`` over ``n_dev`` devices.

    ``n_parts % n_dev != 0`` is padded with empty partitions (zero-width ELL
    tiles, no rows) so any mesh size works; the padded slots carry no
    entries and their x/y coordinates stay exactly zero.
    """
    bump("build_halo_plan")
    rows, cols, src = _live_entries(e)
    ppd = -(-e.n_parts // n_dev)
    n_parts_pad = ppd * n_dev
    L = ppd * e.vec_size
    N = n_dev * L
    own_r = rows // L
    own_c = cols // L

    u_cols, u_rows = _pair_unique_counts(rows, cols, own_r, own_c, n_dev, N)
    any_pair = (u_cols > 0) | (u_rows > 0)
    direction = np.zeros((n_dev, n_dev), dtype=np.int8)
    direction[any_pair] = np.where(u_rows < u_cols, _PUSH, _FETCH)[any_pair]
    np.fill_diagonal(direction, 0)

    is_local = own_r == own_c
    is_push = (direction[own_r, own_c] == _PUSH) & ~is_local
    is_fetch_side = ~is_push                # local + cross-device fetch

    counts_fetch = np.where(direction == _FETCH, u_cols, 0).astype(np.int64)
    counts_push = np.where(direction == _PUSH, u_rows, 0).astype(np.int64)
    S = max(int(np.maximum(counts_fetch, counts_push).max(initial=0)), 1)
    S = -(-S // sublane) * sublane

    # ---- fetched halos + send-side gather schedule ------------------------
    halos = []
    for d in range(n_dev):
        sel = is_fetch_side & ~is_local & (own_r == d)
        halos.append(np.unique(cols[sel]))
    H = max(max((len(h) for h in halos), default=0), 1)
    H = -(-H // sublane) * sublane
    send_idx = np.zeros((n_dev, n_dev, S), dtype=np.int32)
    send_mask = np.zeros((n_dev, n_dev, S), dtype=bool)
    recv_sel = np.zeros((n_dev, H), dtype=np.int32)
    for d in range(n_dev):
        pos = 0
        for s in range(n_dev):
            if direction[d, s] != _FETCH:
                continue
            cs = halos[d][(halos[d] >= s * L) & (halos[d] < (s + 1) * L)]
            send_idx[s, d, : len(cs)] = (cs - s * L).astype(np.int32)
            send_mask[s, d, : len(cs)] = True
            recv_sel[d, pos: pos + len(cs)] = s * S + np.arange(len(cs))
            pos += len(cs)
        assert pos == len(halos[d])

    # ---- push-side: partial-y entries grouped by source device -----------
    rows_push = {}                      # (d, s) -> sorted unique dest rows
    for d in range(n_dev):
        for s in range(n_dev):
            if direction[d, s] == _PUSH:
                sel = is_push & (own_r == d) & (own_c == s)
                rows_push[(d, s)] = np.unique(rows[sel])
    PE = 1
    for s in range(n_dev):
        PE = max(PE, int((is_push & (own_c == s)).sum()))
    pe_cols = np.zeros((n_dev, PE), dtype=np.int32)
    pe_dst = np.zeros((n_dev, PE), dtype=np.int32)
    pe_mask = np.zeros((n_dev, PE), dtype=bool)
    pe_src = np.zeros((n_dev, PE), dtype=np.int64)
    for s in range(n_dev):
        pos = 0
        for d in range(n_dev):
            if direction[d, s] != _PUSH:
                continue
            sel = np.flatnonzero(is_push & (own_r == d) & (own_c == s))
            slot = np.searchsorted(rows_push[(d, s)], rows[sel])
            k = len(sel)
            pe_cols[s, pos: pos + k] = (cols[sel] - s * L).astype(np.int32)
            pe_dst[s, pos: pos + k] = (d * S + slot).astype(np.int32)
            pe_src[s, pos: pos + k] = src[sel]
            pe_mask[s, pos: pos + k] = True
            pos += k

    PR = 1
    for d in range(n_dev):
        PR = max(PR, int(counts_push[d].sum()))
    rp_sel = np.zeros((n_dev, PR), dtype=np.int32)
    rp_rows = np.zeros((n_dev, PR), dtype=np.int32)
    rp_mask = np.zeros((n_dev, PR), dtype=bool)
    for d in range(n_dev):
        pos = 0
        for s in range(n_dev):
            if direction[d, s] != _PUSH:
                continue
            rs = rows_push[(d, s)]
            rp_sel[d, pos: pos + len(rs)] = s * S + np.arange(len(rs))
            rp_rows[d, pos: pos + len(rs)] = (rs - d * L).astype(np.int32)
            rp_mask[d, pos: pos + len(rs)] = True
            pos += len(rs)

    # ---- fetch-side ER tables with COMPACT columns ------------------------
    idx_f = np.flatnonzero(is_fetch_side)
    order = np.lexsort((cols[idx_f], rows[idx_f]))
    idx_f = idx_f[order]
    rf, cf = rows[idx_f], cols[idx_f]
    urow, row_inv, row_cnt = np.unique(rf, return_inverse=True,
                                       return_counts=True)
    dev_of_row = urow // L
    rows_per_dev = np.bincount(dev_of_row, minlength=n_dev) \
        if len(urow) else np.zeros(n_dev, dtype=np.int64)
    Rf = max(int(rows_per_dev.max(initial=0)), 1)
    Wf = max(int(row_cnt.max(initial=0)), 1)
    dev_start = np.concatenate([[0], np.cumsum(rows_per_dev)])
    slot_of_row = np.arange(len(urow)) - dev_start[dev_of_row]
    row_start = np.concatenate([[0], np.cumsum(row_cnt)])
    k_of = np.arange(len(idx_f)) - row_start[row_inv]
    # compact column renumbering per row-owner device
    dev_e = rows[idx_f] // L
    compact = np.empty(len(idx_f), dtype=np.int64)
    loc = own_c[idx_f] == dev_e
    compact[loc] = cf[loc] - dev_e[loc] * L
    for d in range(n_dev):
        sel = ~loc & (dev_e == d)
        compact[sel] = L + np.searchsorted(halos[d], cf[sel])
    fer_cols = np.zeros((n_dev, Rf, Wf), dtype=np.int32)
    fer_rows = np.zeros((n_dev, Rf), dtype=np.int32)
    fer_rows[dev_of_row, slot_of_row] = (urow % L).astype(np.int32)
    fer_cols[dev_e, slot_of_row[row_inv], k_of] = compact.astype(np.int32)
    fer_dst = ((dev_e * Rf + slot_of_row[row_inv]) * Wf + k_of).astype(
        np.int64)
    fer_src = src[idx_f]

    has_er = len(rows) > 0
    needs_comm = bool(any_pair.any())
    halo_words = int(counts_fetch.sum() + counts_push.sum())
    per_dev = (counts_fetch.sum(axis=1) + counts_push.sum(axis=1))
    return HaloPlan(
        n_dev=n_dev, parts_per_dev=ppd, n_parts_pad=n_parts_pad,
        local_size=L, n_pad_dist=N, n_pad=e.n_pad,
        seg_len=S, halo_len=H, direction=direction,
        counts_fetch=counts_fetch, counts_push=counts_push,
        send_idx=send_idx, send_mask=send_mask, recv_sel=recv_sel,
        pe_cols=pe_cols, pe_dst=pe_dst, pe_mask=pe_mask, pe_src=pe_src,
        rp_sel=rp_sel, rp_rows=rp_rows, rp_mask=rp_mask,
        fer_cols=fer_cols, fer_rows=fer_rows, fer_dst=fer_dst,
        fer_src=fer_src,
        has_er=has_er, needs_comm=needs_comm,
        has_push=bool(counts_push.any()),
        halo_words=halo_words,
        buffer_words=n_dev * n_dev * S,
        allgather_words=2 * n_dev * e.n_pad,
        per_device_words=per_dev)


def fetch_layout(hp: HaloPlan, rank: int) -> dict:
    """Device layout of rank ``rank``'s fetch-side ER table, for the ER
    kernel (#6), which reads each row's live prefix only and needs the rows
    in non-increasing live width.

    The host plan keeps the reference's order: row slot ``i`` of device
    ``d`` holds its live entries in ``fer_cols[d, i, :w_i]`` (a prefix,
    from ``fer_dst``).  Here the rank's live rows (``w_i > 0``) are sorted
    by descending width (stable), and the table is cut to them and to the
    widest row.  Returns host arrays, all from the pattern:

    * ``rows`` (Rd,) int64 — the plan's row slot of each device row;
    * ``cols`` (Rd, Wd) int32 — compact columns (0 past a row's width);
    * ``fer_rows`` (Rd,) int64 — local destination rows, unique;
    * ``col_rows`` (Wd,) int32 — rows with more than k live entries;
    * ``dst``/``src`` — the rank's value fill: ``vals.flat[dst] =
      er_vals.flat[src]`` on the (Rd, Wd) table.
    """
    rf, wf = hp.fer_cols.shape[1:]
    dst = np.asarray(hp.fer_dst, dtype=np.int64)
    mine = dst // (rf * wf) == rank
    slot, k = np.divmod(dst[mine] - rank * rf * wf, wf)
    width = np.bincount(slot, minlength=rf)
    live = np.flatnonzero(width)
    rows = live[np.argsort(-width[live], kind="stable")]
    wd = int(width.max(initial=0))
    new_slot = np.empty(rf, dtype=np.int64)
    new_slot[rows] = np.arange(len(rows))
    cols = np.zeros((len(rows), wd), dtype=np.int32)
    cols[new_slot[slot], k] = hp.fer_cols[rank, slot, k]
    col_rows = (width[rows][None, :] > np.arange(wd)[:, None]).sum(
        axis=1).astype(np.int32)
    return {"rows": rows,
            "cols": cols,
            "fer_rows": hp.fer_rows[rank, rows].astype(np.int64),
            "col_rows": col_rows,
            "dst": new_slot[slot] * wd + k,
            "src": np.asarray(hp.fer_src, dtype=np.int64)[mine]}
