"""Declarative format-invariant verifier (static analysis pass 1 of 3).

The port of ``repro.analysis.invariants``.  The EHYB pipeline rests on
structural invariants the paper states but the runtime never re-checks:
the §3.4 compact ``uint16`` local index must stay ``< vec_size``, the
Algorithm-1 permutation must be a bijection, the recorded ``fill_plan``
scatter must cover the live entry set exactly once.  On a TPU, XLA clamps
an out-of-range gather, so a bad index gives a wrong number; on the card
it is worse: a local column ``>= vec_size`` makes a kernel read outside
its block's shared-memory x-slice, and a bad ``er_s_cols`` entry outside
x.  This pass makes the invariants checkable:

    from repro_torch.analysis import verify, verify_plan

    findings = verify(obj)          # any host/device container or operator
    findings = verify_plan(plan)    # a repro_torch.api.Plan, or a HaloPlan

Both return structured :class:`~repro_torch.analysis.findings.Finding`
records (empty list = clean).  ``Plan.bind(validate=...)`` runs the cheap
subset by default (finite values, pattern index bounds) and the full
per-format verifier under ``validate="full"``.  Host builds are checked
with numpy; device containers with torch ops on the container's own
device, so a card container is never copied to the host (only scalars —
counts, minima, maxima — come back).

Besides the reference's fields, the port's containers carry tables laid
out from the pattern that the kernels index with; they are checked under
the reference's rule ids:

* ``col_rows`` (P, W) and ``er_col_rows`` (We,) — ``width-consistency``:
  in range and non-increasing, and, given the host build, equal to the
  widths its pattern gives;
* the compact ER stream ``er_s_part_ptr``/``er_s_row_ptr``/``er_s_rows``/
  ``er_s_cols`` — ``index-bound.er-global`` for its local rows and global
  columns, ``fill-plan-bijection`` for its pointers covering its rows and
  entries exactly once (each live ER row once) and, given the host build,
  for the stream equal to the live entries of the grouped ER tiles.

Rule ids (stable — the baseline and the tests key on them):

  index-bound.ell-local    ELL local columns < vec_size (§3.4 uint16 index)
  index-bound.er-global    ER global columns/rows inside [0, n_pad), ER
                           local rows inside [0, vec_size)
  index-bound.stream       COO/ELL/HYB global indices inside [0, n)
  perm-bijection           perm & inv_perm bijections of [0, n_pad), mutual
                           inverses (Algorithm 1)
  partition-capacity       part_vec inside [0, n_parts), no partition over
                           vec_size vertices, perm slots agree with
                           part_vec, padding only at partition tails
  width-consistency        part_widths / slice_widths / bucket widths /
                           col_rows / er_col_rows match the pattern row
                           widths; nothing truncated
  staircase-monotone       row widths non-increasing inside each partition
                           (what makes the packed prefix property valid)
  padding-sentinel         padded slots zero-valued; live entries never
                           reference padding vertices
  fill-plan-bijection      fill_plan dst unique, src a bijection onto the
                           CSR entry stream; the compact ER stream covers
                           the live ER entries once
  value-finite             no NaN/Inf in any value table
  bucket-cover             bucket part_ids partition [0, n_parts) exactly
  halo-coverage            every cross-device ER reference covered by
                           exactly one x-fetch segment or y-push entry
  halo-push-race           duplicate scatter-add destination inside one
                           push segment
  halo-accounting          halo_words / buffer_words / per-device words
                           match the recorded schedule

The halo rules check the host :class:`~repro_torch.dist.HaloPlan`
(:func:`check_halo_plan`, the reference's, on the same arrays); a rank's
``EHYBShards`` is checked on its device under the index-bound,
width-consistency, perm-bijection and value-finite rules
(:func:`check_shards_device`).

Formats plug in through the ``FormatSpec.invariants`` registry hook —
``verify`` consults it for any operator whose format is registered.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .findings import Finding

__all__ = ["verify", "verify_plan", "format_invariants", "Finding",
           "RULES"]

# every rule id this pass can emit
RULES = (
    "index-bound.ell-local", "index-bound.er-global", "index-bound.stream",
    "perm-bijection", "partition-capacity", "width-consistency",
    "staircase-monotone", "padding-sentinel", "fill-plan-bijection",
    "value-finite", "bucket-cover", "halo-coverage", "halo-push-race",
    "halo-accounting",
)


def _f(sev, site, rule, msg) -> Finding:
    return Finding(sev, site, rule, msg)


def _t(a) -> torch.Tensor:
    """A tensor view of ``a`` (a host array is wrapped, not copied)."""
    return a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))


def _finite(out: List[Finding], site: str, name: str, arr) -> None:
    a = _t(arr)
    if a.is_floating_point() and a.numel() and \
            not bool(torch.isfinite(a).all()):
        bad = int((~torch.isfinite(a)).sum())
        out.append(_f("error", f"{site}.{name}", "value-finite",
                      f"{bad} non-finite value(s) in {name}"))


def _minmax(a: torch.Tensor) -> tuple:
    """(min, max) of an integer tensor as Python ints (uint16 widened,
    since few ops take it)."""
    if a.dtype in (torch.uint16, torch.uint32, torch.uint64):
        a = a.to(torch.int64)
    lo, hi = torch.aminmax(a)
    return int(lo), int(hi)


def _bound(out: List[Finding], site: str, name: str, arr, hi: int,
           rule: str, lo: int = 0) -> None:
    a = _t(arr)
    if a.numel():
        amin, amax = _minmax(a)
        if amin < lo or amax >= hi:
            out.append(_f("error", f"{site}.{name}", rule,
                          f"{name} range [{amin}, {amax}] escapes "
                          f"[{lo}, {hi})"))


def _check_perm_pair(out: List[Finding], site: str, perm, inv_perm,
                     n_pad: int) -> None:
    p, q = _t(perm), _t(inv_perm)
    if tuple(p.shape) != (n_pad,) or tuple(q.shape) != (n_pad,):
        out.append(_f("error", site, "perm-bijection",
                      f"perm/inv_perm shapes {tuple(p.shape)}/"
                      f"{tuple(q.shape)} != ({n_pad},)"))
        return
    ar = torch.arange(n_pad, device=p.device, dtype=p.dtype)
    if not torch.equal(torch.sort(p).values, ar):
        out.append(_f("error", f"{site}.perm", "perm-bijection",
                      f"perm is not a bijection of [0, {n_pad})"))
    elif not torch.equal(torch.sort(q).values, ar.to(q.dtype)):
        out.append(_f("error", f"{site}.inv_perm", "perm-bijection",
                      f"inv_perm is not a bijection of [0, {n_pad})"))
    elif not torch.equal(p[q.to(torch.int64)], ar):
        out.append(_f("error", site, "perm-bijection",
                      "perm and inv_perm are not mutual inverses"))


def _non_increasing(a: torch.Tensor) -> bool:
    """Whether ``a`` never increases along its last axis."""
    return a.shape[-1] < 2 or not bool((a[..., 1:] > a[..., :-1]).any())


# ---------------------------------------------------------------------------
# raw partitions (the strategy-registry contract)
# ---------------------------------------------------------------------------

def check_partition(p) -> List[Finding]:
    """Invariants of a raw :class:`repro_torch.core.partition.Partition`.

    Every registered strategy must produce a clean one — this is the
    contract ``build_ehyb`` assumes when it reorders by ``perm`` and sizes
    the per-partition x-cache by ``vec_size``; a partition loaded from the
    tune store must keep it too."""
    site = f"Partition[{p.method or '?'}]"
    out: List[Finding] = []
    if p.n_parts * p.vec_size != p.n_pad:
        out.append(_f("error", site, "partition-capacity",
                      f"n_parts*vec_size = {p.n_parts * p.vec_size} != "
                      f"n_pad = {p.n_pad}"))
        return out
    pv = np.asarray(p.part_vec)
    if pv.shape != (p.n,):
        out.append(_f("error", f"{site}.part_vec", "partition-capacity",
                      f"part_vec shape {pv.shape} != ({p.n},)"))
        return out
    _bound(out, site, "part_vec", pv, p.n_parts, "partition-capacity")
    if out:
        return out
    counts = np.bincount(pv, minlength=p.n_parts) if pv.size else \
        np.zeros(p.n_parts, dtype=np.int64)
    if pv.size and int(counts.max()) > p.vec_size:
        over = int((counts > p.vec_size).sum())
        out.append(_f("error", f"{site}.part_vec", "partition-capacity",
                      f"{over} partition(s) hold more than vec_size = "
                      f"{p.vec_size} vertices (max {int(counts.max())})"))
    _check_perm_pair(out, site, p.perm, p.inv_perm, p.n_pad)
    perm = np.asarray(p.perm)
    if perm.shape == (p.n_pad,) and not out:
        live = perm < p.n
        slot_part = np.arange(p.n_pad) // p.vec_size
        if not np.array_equal(slot_part[live], pv[perm[live]]):
            bad = int((slot_part[live] != pv[perm[live]]).sum())
            out.append(_f("error", f"{site}.perm", "partition-capacity",
                          f"{bad} live slot(s) placed outside the "
                          f"partition part_vec assigns"))
        lv = live.reshape(p.n_parts, p.vec_size)
        if bool((lv[:, 1:] & ~lv[:, :-1]).any()):
            out.append(_f("error", f"{site}.perm", "partition-capacity",
                          "padding slots interleaved with live vertices "
                          "(must sit at each partition's tail)"))
    return out


# ---------------------------------------------------------------------------
# host EHYB (+ packed / bucketed views)
# ---------------------------------------------------------------------------

def check_ehyb_host(e) -> List[Finding]:
    """Invariants of a host :class:`repro_torch.core.ehyb.EHYB` build."""
    site = "EHYB"
    out: List[Finding] = []
    P, V, W = e.n_parts, e.vec_size, e.ell_width
    if P * V != e.n_pad:
        out.append(_f("error", site, "width-consistency",
                      f"n_parts*vec_size = {P * V} != n_pad = {e.n_pad}"))
        return out
    _bound(out, site, "ell_cols", e.ell_cols, V, "index-bound.ell-local")
    _bound(out, site, "er_cols", e.er_cols, e.n_pad, "index-bound.er-global")
    _bound(out, site, "er_row_idx", e.er_row_idx, e.n_pad,
           "index-bound.er-global")
    _check_perm_pair(out, site, e.perm, e.inv_perm, e.n_pad)
    _finite(out, site, "ell_vals", e.ell_vals)
    _finite(out, site, "er_vals", e.er_vals)

    plan = e.fill_plan
    if plan is None:
        out.append(_f("info", site, "fill-plan-bijection",
                      "container predates fill plans; pattern-level rules "
                      "checked against the nonzero mask only"))
        widths = (np.asarray(e.ell_vals) != 0).sum(axis=2).reshape(-1)
    else:
        widths = np.asarray(plan["ell_widths"], dtype=np.int64)
        out += _check_fill_plan(e, plan, widths)

    # ---- width metadata vs pattern row widths -----------------------------
    w2 = widths.reshape(P, V)
    if widths.size and int(widths.max()) > W:
        out.append(_f("error", site, "width-consistency",
                      f"pattern row width {int(widths.max())} exceeds "
                      f"ell_width {W}"))
    pw = np.asarray(e.part_widths)
    if not np.array_equal(pw, w2.max(axis=1)):
        out.append(_f("error", f"{site}.part_widths", "width-consistency",
                      "part_widths do not match per-partition max row "
                      "widths"))
    if e.slice_widths is not None:
        sw = np.asarray(e.slice_widths)
        sublane = V // sw.shape[1]
        want = w2.reshape(P, sw.shape[1], sublane).max(axis=2)
        if not np.array_equal(sw, want):
            out.append(_f("error", f"{site}.slice_widths",
                          "width-consistency",
                          "slice_widths do not match per-slice max row "
                          "widths"))
    if np.any(w2[:, 1:] > w2[:, :-1]):
        p_bad = int(np.argwhere(w2[:, 1:] > w2[:, :-1])[0, 0])
        out.append(_f("error", f"{site}.partition[{p_bad}]",
                      "staircase-monotone",
                      "row widths are not non-increasing inside the "
                      "partition (Algo 1 length sort violated)"))

    # ---- padding discipline ----------------------------------------------
    perm = np.asarray(e.perm)
    pad_rows = perm >= e.n               # slots holding padding vertices
    if np.any(widths[pad_rows] > 0):
        out.append(_f("error", site, "padding-sentinel",
                      f"{int((widths[pad_rows] > 0).sum())} padding slot(s) "
                      f"carry matrix entries"))
    if plan is not None:
        ell_dst = np.asarray(plan["ell_dst"], dtype=np.int64)
        er_dst = np.asarray(plan["er_dst"], dtype=np.int64)
        live_ell = np.zeros(e.n_pad * W, dtype=bool)
        live_ell[ell_dst[ell_dst < live_ell.size]] = True
        ev = np.asarray(e.ell_vals).reshape(-1)
        if ev[~live_ell].any():
            out.append(_f("error", f"{site}.ell_vals", "padding-sentinel",
                          "nonzero values in ELL slots outside the live "
                          "pattern"))
        live_er = np.zeros(e.er_rows * e.er_width, dtype=bool)
        live_er[er_dst[er_dst < live_er.size]] = True
        rv = np.asarray(e.er_vals).reshape(-1)
        if rv[~live_er].any():
            out.append(_f("error", f"{site}.er_vals", "padding-sentinel",
                          "nonzero values in ER slots outside the live "
                          "pattern"))
        # live entries must never reference padding vertices
        cols_ell = np.asarray(e.ell_cols).reshape(-1)[
            ell_dst[ell_dst < e.n_pad * W]]
        rows_ell = ell_dst[ell_dst < e.n_pad * W] // W
        gcols = (rows_ell // V) * V + cols_ell
        gcols = gcols[(gcols >= 0) & (gcols < e.n_pad)]  # OOB found above
        if gcols.size and np.any(perm[gcols] >= e.n):
            out.append(_f("error", f"{site}.ell_cols", "padding-sentinel",
                          "live ELL entries reference padding vertices"))
        er_slots = er_dst[er_dst < e.er_rows * e.er_width] // e.er_width
        er_cols_live = np.asarray(e.er_cols).reshape(-1)[
            er_dst[er_dst < e.er_rows * e.er_width]]
        touched = np.concatenate([np.asarray(e.er_row_idx)[er_slots],
                                  er_cols_live])
        touched = touched[(touched >= 0) & (touched < e.n_pad)]
        if touched.size and np.any(perm[touched] >= e.n):
            out.append(_f("error", f"{site}.er", "padding-sentinel",
                          "live ER entries reference padding vertices"))
    return out


def _check_fill_plan(e, plan, widths) -> List[Finding]:
    site = "EHYB.fill_plan"
    out: List[Finding] = []
    W = e.ell_width
    ell_dst = np.asarray(plan["ell_dst"], dtype=np.int64)
    ell_src = np.asarray(plan["ell_src"], dtype=np.int64)
    er_dst = np.asarray(plan["er_dst"], dtype=np.int64)
    er_src = np.asarray(plan["er_src"], dtype=np.int64)
    _bound(out, site, "ell_dst", ell_dst, e.n_pad * W, "fill-plan-bijection")
    _bound(out, site, "er_dst", er_dst, e.er_rows * e.er_width,
           "fill-plan-bijection")
    if len(np.unique(ell_dst)) != len(ell_dst):
        out.append(_f("error", f"{site}.ell_dst", "fill-plan-bijection",
                      "duplicate ELL destination slots (two entries would "
                      "overwrite one cell)"))
    if len(np.unique(er_dst)) != len(er_dst):
        out.append(_f("error", f"{site}.er_dst", "fill-plan-bijection",
                      "duplicate ER destination slots"))
    src = np.concatenate([ell_src, er_src])
    if not np.array_equal(np.sort(src), np.arange(e.nnz)):
        out.append(_f("error", site, "fill-plan-bijection",
                      f"ell_src ∪ er_src is not a bijection onto the "
                      f"{e.nnz}-entry CSR stream (stale or corrupted plan)"))
    if int(widths.sum()) != len(ell_src):
        out.append(_f("error", f"{site}.ell_widths", "fill-plan-bijection",
                      f"ell_widths sum {int(widths.sum())} != "
                      f"{len(ell_src)} recorded ELL entries"))
    elif not np.array_equal(np.bincount(ell_dst // W, minlength=e.n_pad)
                            if ell_dst.size else np.zeros(e.n_pad, np.int64),
                            widths):
        out.append(_f("error", f"{site}.ell_widths", "fill-plan-bijection",
                      "ell_widths do not match the per-row destination "
                      "counts"))
    n_live = int(plan["n_er_live"])
    if er_dst.size:
        slots = np.unique(er_dst // e.er_width)
        if slots.size and int(slots.max()) >= n_live:
            out.append(_f("error", f"{site}.n_er_live",
                          "fill-plan-bijection",
                          f"live ER slot {int(slots.max())} outside the "
                          f"recorded n_er_live={n_live}"))
    return out


def check_packed_host(pk) -> List[Finding]:
    """Invariants of a host ``PackedEHYB`` staircase packing (+ its base)."""
    site = "PackedEHYB"
    e = pk.base
    out = check_ehyb_host(e)
    P, V = e.n_parts, e.vec_size
    cr = np.asarray(pk.col_rows)
    cs = np.asarray(pk.col_starts)
    _bound(out, site, "packed_cols", pk.packed_cols, V,
           "index-bound.ell-local")
    _finite(out, site, "packed_vals", pk.packed_vals)
    if np.any(cr[:, 1:] > cr[:, :-1]):
        out.append(_f("error", f"{site}.col_rows", "staircase-monotone",
                      "active-row counts increase with column index (the "
                      "packed prefix property is broken)"))
    if cr.size and (int(cr.min()) < 0 or int(cr.max()) > V):
        out.append(_f("error", f"{site}.col_rows", "width-consistency",
                      f"col_rows escape [0, {V}]"))
    if not (np.array_equal(cs[:, 0], np.zeros(P, dtype=cs.dtype))
            and np.array_equal(np.diff(cs, axis=1), cr)):
        out.append(_f("error", f"{site}.col_starts", "width-consistency",
                      "col_starts is not the running sum of col_rows"))
    elif int(cs[:, -1].max(initial=0)) > pk.packed_len:
        out.append(_f("error", f"{site}.col_starts", "width-consistency",
                      f"packed stream length {int(cs[:, -1].max())} exceeds "
                      f"packed_len {pk.packed_len}"))
    if pk.pack_plan is not None:
        pp = pk.pack_plan
        key = np.asarray(pp["pi"], np.int64) * pk.packed_len + \
            np.asarray(pp["dest"], np.int64)
        if len(np.unique(key)) != len(key):
            out.append(_f("error", f"{site}.pack_plan",
                          "fill-plan-bijection",
                          "duplicate packed destination slots"))
        live = np.zeros(P * pk.packed_len, dtype=bool)
        live[key] = True
        if np.asarray(pk.packed_vals).reshape(-1)[~live].any():
            out.append(_f("error", f"{site}.packed_vals", "padding-sentinel",
                          "nonzero values outside the recorded pack "
                          "scatter"))
    return out


def check_buckets_host(b) -> List[Finding]:
    """Invariants of a host ``EHYBBuckets`` view (+ its base)."""
    site = "EHYBBuckets"
    e = b.base
    out = check_ehyb_host(e)
    ids = (np.concatenate([np.asarray(c) for c in b.part_ids])
           if b.part_ids else np.empty(0, np.int64))
    if not np.array_equal(np.sort(ids), np.arange(e.n_parts)):
        out.append(_f("error", f"{site}.part_ids", "bucket-cover",
                      f"bucket part_ids do not partition "
                      f"[0, {e.n_parts}) exactly once"))
        return out
    pw = np.asarray(e.part_widths)
    for i, (ch, w, cols) in enumerate(zip(b.part_ids, b.widths, b.cols)):
        if np.asarray(cols).shape[2] != w:
            out.append(_f("error", f"{site}.bucket[{i}]",
                          "width-consistency",
                          f"tile width {np.asarray(cols).shape[2]} != "
                          f"declared bucket width {w}"))
        if len(ch) and int(pw[np.asarray(ch)].max()) > w:
            out.append(_f("error", f"{site}.bucket[{i}]",
                          "width-consistency",
                          f"bucket width {w} truncates a partition of "
                          f"width {int(pw[np.asarray(ch)].max())}"))
        _bound(out, f"{site}.bucket[{i}]", "cols", cols, e.vec_size,
               "index-bound.ell-local")
        _finite(out, f"{site}.bucket[{i}]", "vals", b.vals[i])
    return out


# ---------------------------------------------------------------------------
# device containers (one checker per registered format), on their device
# ---------------------------------------------------------------------------

def _check_er_tables(out, site, d) -> None:
    # the bucketed device carries only the partition-grouped tables; the
    # uniform/packed devices also keep the flat global ones
    for name, hi in (("er_cols", d.n_pad), ("er_row_idx", d.n_pad),
                     ("er_p_cols", d.n_pad), ("er_p_rows", d.vec_size)):
        arr = getattr(d, name, None)
        if arr is not None:
            _bound(out, site, name, arr, hi, "index-bound.er-global")
    er_tables = [n for n in ("er_vals", "er_p_vals", "er_s_vals")
                 if getattr(d, n, None) is not None]
    for name in er_tables:
        _finite(out, site, name, getattr(d, name))
    if not d.has_er:
        if any(bool(getattr(d, n).any()) for n in er_tables):
            out.append(_f("error", site, "width-consistency",
                          "has_er=False but ER value tables are nonzero "
                          "(the applies drop the ER stage)"))


def _check_col_rows(out, site, col_rows, V: int, host=None) -> None:
    """(P, W) rows per ELL column: in [0, V], non-increasing along W, and
    the pattern's (``core.spmv.column_rows``) given the host build."""
    from ..core.spmv import column_rows

    cr = _t(col_rows)
    if cr.numel():
        lo, hi = _minmax(cr)
        if lo < 0 or hi > V:
            out.append(_f("error", f"{site}.col_rows", "width-consistency",
                          f"col_rows escape [0, {V}]"))
    if not _non_increasing(cr):
        out.append(_f("error", f"{site}.col_rows", "staircase-monotone",
                      "active-row counts increase with column index (the "
                      "kernels' row widths are broken)"))
    if host is not None and host.fill_plan is not None:
        want = torch.from_numpy(column_rows(host)).to(cr.device)
        if cr.shape != want.shape or not torch.equal(cr, want):
            out.append(_f("error", f"{site}.col_rows", "width-consistency",
                          "col_rows do not match the row widths the "
                          "pattern gives"))


def _check_stream(out, site, d, host=None) -> None:
    """The port's pattern-laid tables beside the ER tiles: ``er_col_rows``
    and the compact ER stream ``er_s_*`` (see the module docstring)."""
    from ..core.ehyb import er_stream
    from ..core.spmv import er_column_rows

    ecr = _t(d.er_col_rows)
    r_er = d.er_vals.shape[0]
    if ecr.numel():
        lo, hi = _minmax(ecr)
        if lo < 0 or hi > r_er:
            out.append(_f("error", f"{site}.er_col_rows",
                          "width-consistency",
                          f"er_col_rows escape [0, {r_er}]"))
    if not _non_increasing(ecr):
        out.append(_f("error", f"{site}.er_col_rows", "width-consistency",
                      "er_col_rows increase with column index (the ER "
                      "rows' live prefixes are broken)"))
    part_ptr, row_ptr = d.er_s_part_ptr, d.er_s_row_ptr
    rows, cols = d.er_s_rows, d.er_s_cols
    _bound(out, site, "er_s_rows", rows, d.vec_size, "index-bound.er-global")
    _bound(out, site, "er_s_cols", cols, d.n_pad, "index-bound.er-global")
    n_rows, n_ent = rows.shape[0], cols.shape[0]
    ptr_ok = True
    for name, ptr, n_ptr, n_end in (("er_s_part_ptr", part_ptr,
                                     d.n_parts + 1, n_rows),
                                    ("er_s_row_ptr", row_ptr, n_rows + 1,
                                     n_ent)):
        if tuple(ptr.shape) != (n_ptr,) or int(ptr[0]) != 0 or \
                int(ptr[-1]) != n_end or bool((ptr[1:] < ptr[:-1]).any()):
            ptr_ok = False
            out.append(_f("error", f"{site}.{name}", "fill-plan-bijection",
                          f"{name} is not a pointer array from 0 to {n_end} "
                          f"over {n_ptr - 1} segments"))
    if d.er_s_vals.shape[0] != n_ent:
        out.append(_f("error", f"{site}.er_s_vals", "fill-plan-bijection",
                      f"{d.er_s_vals.shape[0]} stream values for {n_ent} "
                      f"stream columns"))
    if ptr_ok and n_rows:
        owner = torch.repeat_interleave(
            torch.arange(d.n_parts, device=rows.device),
            (part_ptr[1:] - part_ptr[:-1]).to(torch.int64))
        slot = owner * d.vec_size + rows.to(torch.int64)
        if torch.unique(slot).numel() != n_rows:
            out.append(_f("error", f"{site}.er_s_rows",
                          "fill-plan-bijection",
                          "two stream rows of a partition share a local row "
                          "(the kernels add each row's sum with a plain "
                          "add)"))
    if host is None or host.fill_plan is None:
        return
    try:
        want_ecr = er_column_rows(host)
        s = er_stream(host)
    except ValueError as e:
        out.append(_f("error", site, "fill-plan-bijection",
                      f"the host build's ER layout is not a stream: {e}"))
        return
    dev = rows.device
    if ecr.shape != want_ecr.shape or not torch.equal(
            ecr, torch.from_numpy(want_ecr).to(dev)):
        out.append(_f("error", f"{site}.er_col_rows", "width-consistency",
                      "er_col_rows do not match the ER row widths the "
                      "pattern gives"))
    for name, got, key in (("er_s_part_ptr", part_ptr, "part_ptr"),
                           ("er_s_row_ptr", row_ptr, "row_ptr"),
                           ("er_s_rows", rows, "rows")):
        want = torch.from_numpy(s[key]).to(dev)
        if got.shape != want.shape or not torch.equal(got, want):
            out.append(_f("error", f"{site}.{name}", "fill-plan-bijection",
                          f"{name} does not lay out the pattern's live ER "
                          f"rows once each"))
    if tuple(d.er_p_vals.shape) == s["tile_shape"] and \
            n_ent == s["pos"].shape[0]:
        pos = torch.from_numpy(s["pos"]).to(dev)
        if not torch.equal(cols, d.er_p_cols.reshape(-1)[pos]) or \
                not torch.equal(d.er_s_vals, d.er_p_vals.reshape(-1)[pos]):
            out.append(_f("error", site, "fill-plan-bijection",
                          "the compact ER stream differs from the live "
                          "entries of the grouped ER tiles"))
    else:
        out.append(_f("error", site, "fill-plan-bijection",
                      f"{n_ent} stream entries and tiles "
                      f"{tuple(d.er_p_vals.shape)} against the pattern's "
                      f"{s['pos'].shape[0]} live ER entries in tiles "
                      f"{s['tile_shape']}"))


def _check_geometry(out, site, d) -> bool:
    if d.n_parts * d.vec_size != d.n_pad or d.n > d.n_pad:
        out.append(_f("error", site, "width-consistency",
                      f"geometry n_parts*vec_size={d.n_parts * d.vec_size} "
                      f"n_pad={d.n_pad} n={d.n} is inconsistent"))
        return False
    return True


def check_ehyb_device(d, host=None) -> List[Finding]:
    """Invariants of an ``EHYBDevice``; ``host`` (the host build it was
    bound from) also holds its pattern-laid tables to the pattern."""
    site = "EHYBDevice"
    out: List[Finding] = []
    if not _check_geometry(out, site, d):
        return out
    _bound(out, site, "ell_cols", d.ell_cols, d.vec_size,
           "index-bound.ell-local")
    _finite(out, site, "ell_vals", d.ell_vals)
    _check_er_tables(out, site, d)
    _check_col_rows(out, site, d.col_rows, d.vec_size, host)
    if tuple(d.col_rows.shape) != (d.n_parts, d.ell_cols.shape[2]):
        out.append(_f("error", f"{site}.col_rows", "width-consistency",
                      f"col_rows shape {tuple(d.col_rows.shape)} != "
                      f"({d.n_parts}, {d.ell_cols.shape[2]})"))
    _check_stream(out, site, d, host)
    _check_perm_pair(out, site, d.perm, d.inv_perm, d.n_pad)
    return out


def check_packed_device(d, host=None) -> List[Finding]:
    """Invariants of an ``EHYBPackedDevice`` (``host``: see
    :func:`check_ehyb_device`)."""
    site = "EHYBPackedDevice"
    out: List[Finding] = []
    if not _check_geometry(out, site, d):
        return out
    _bound(out, site, "packed_cols", d.packed_cols, d.vec_size,
           "index-bound.ell-local")
    _finite(out, site, "packed_vals", d.packed_vals)
    cr, cs = d.col_rows, d.col_starts
    _check_col_rows(out, site, cr, d.vec_size, host)
    if not (cs.shape[0] == cr.shape[0] and cs.shape[1] == cr.shape[1] + 1
            and not bool(cs[:, 0].any())
            and torch.equal(cs[:, 1:] - cs[:, :-1], cr)):
        out.append(_f("error", f"{site}.col_starts", "width-consistency",
                      "col_starts is not the running sum of col_rows"))
    elif cs.numel() and int(cs[:, -1].max()) > d.packed_vals.shape[1]:
        out.append(_f("error", f"{site}.col_starts", "width-consistency",
                      "packed stream overruns the packed value table"))
    _check_er_tables(out, site, d)
    _check_stream(out, site, d, host)
    _check_perm_pair(out, site, d.perm, d.inv_perm, d.n_pad)
    return out


def check_buckets_device(d, host=None) -> List[Finding]:
    """Invariants of an ``EHYBBucketsDevice``."""
    site = "EHYBBucketsDevice"
    out: List[Finding] = []
    if not _check_geometry(out, site, d):
        return out
    ids = (torch.cat([_t(p).reshape(-1).to(torch.int64)
                      for p in d.part_ids]) if d.part_ids
           else torch.empty(0, dtype=torch.int64))
    if not torch.equal(torch.sort(ids).values,
                       torch.arange(d.n_parts, device=ids.device)):
        out.append(_f("error", f"{site}.part_ids", "bucket-cover",
                      f"bucket part_ids do not partition "
                      f"[0, {d.n_parts}) exactly once"))
    if sum(c.numel() for c in d.cols) != d.vals.numel():
        out.append(_f("error", f"{site}.vals", "width-consistency",
                      f"{d.vals.numel()} bucket values for "
                      f"{sum(c.numel() for c in d.cols)} tile slots"))
        vals = [None] * len(d.cols)
    else:
        vals = d.bucket_vals()
    for i, (w, v, cols) in enumerate(zip(d.widths, vals, d.cols)):
        if cols.shape[2] != w:
            out.append(_f("error", f"{site}.bucket[{i}]",
                          "width-consistency",
                          f"tile width {cols.shape[2]} != static bucket "
                          f"width {w}"))
        _bound(out, f"{site}.bucket[{i}]", "cols", cols, d.vec_size,
               "index-bound.ell-local")
        if v is not None:
            _finite(out, f"{site}.bucket[{i}]", "vals", v)
    _check_er_tables(out, site, d)
    _check_perm_pair(out, site, d.perm, d.inv_perm, d.n_pad)
    return out


def check_coo_device(d, host=None) -> List[Finding]:
    out: List[Finding] = []
    _bound(out, "COODevice", "rows", d.rows, d.n, "index-bound.stream")
    _bound(out, "COODevice", "cols", d.cols, d.n, "index-bound.stream")
    _finite(out, "COODevice", "vals", d.vals)
    return out


def check_ell_device(d, host=None) -> List[Finding]:
    out: List[Finding] = []
    _bound(out, "ELLDevice", "cols", d.cols, d.n, "index-bound.stream")
    _finite(out, "ELLDevice", "vals", d.vals)
    return out


def check_hyb_device(d, host=None) -> List[Finding]:
    out: List[Finding] = []
    _bound(out, "HYBDevice", "ell_cols", d.ell_cols, d.n,
           "index-bound.stream")
    _bound(out, "HYBDevice", "coo_rows", d.coo_rows, d.n,
           "index-bound.stream")
    _bound(out, "HYBDevice", "coo_cols", d.coo_cols, d.n,
           "index-bound.stream")
    _finite(out, "HYBDevice", "ell_vals", d.ell_vals)
    _finite(out, "HYBDevice", "coo_vals", d.coo_vals)
    return out


def check_dense(a, host=None) -> List[Finding]:
    """The dense format's ``DenseDevice`` (its table must be (n, n)), or a
    bare 2-D table (must be square)."""
    out: List[Finding] = []
    arr = _t(getattr(a, "vals", a))
    n = getattr(a, "n", arr.shape[0] if arr.dim() else 0)
    if tuple(arr.shape) != (n, n):
        out.append(_f("error", "dense", "width-consistency",
                      f"dense operator table has shape {tuple(arr.shape)}, "
                      f"not ({n}, {n})"))
    _finite(out, "dense", "table", arr)
    return out


def check_shards_device(d) -> List[Finding]:
    """Invariants of one rank's ``EHYBShards`` (``repro_torch.dist``), on
    its device: the compact mesh-level index bounds of every table the
    sharded apply indexes with, the widths the ELL-only and ER kernels read
    (``col_rows``, ``fer_col_rows``: in range, non-increasing), the
    permutations and finite values.  The exchange schedule's laws live in
    :func:`check_halo_plan`."""
    site = f"EHYBShards[{d.rank}]"
    out: List[Finding] = []
    L = d.local_size
    slots = d.n_dev * d.seg_len
    _bound(out, site, "ell_cols", d.ell_cols, d.vec_size,
           "index-bound.ell-local")
    # fetch-side ER columns are compact: [0, local_size + halo)
    _bound(out, site, "fer_cols", d.fer_cols, L + d.recv_sel.numel(),
           "index-bound.er-global")
    for name, hi in (("fer_rows", L), ("pe_cols", L), ("send_src", L),
                     ("rp_rows", L), ("pe_dst", slots), ("send_pos", slots),
                     ("recv_sel", slots), ("rp_sel", slots)):
        _bound(out, site, name, getattr(d, name), hi,
               "index-bound.er-global")
    for name, tab, hi in (("col_rows", d.col_rows, d.vec_size),
                          ("fer_col_rows", d.fer_col_rows,
                           d.fer_vals.shape[0])):
        if tab.numel() and (_minmax(tab)[0] < 0 or _minmax(tab)[1] > hi
                            or not _non_increasing(tab)):
            out.append(_f("error", f"{site}.{name}", "width-consistency",
                          f"{name} is not non-increasing inside [0, {hi}]"))
    _check_perm_pair(out, site, d.perm, d.inv_perm, d.n_pad)
    for name in d.VALUE_FIELDS:
        _finite(out, site, name, getattr(d, name))
    return out


# ---------------------------------------------------------------------------
# halo-plan conservation laws
# ---------------------------------------------------------------------------

def check_halo_plan(hp, e=None) -> List[Finding]:
    """Conservation laws of a :class:`repro_torch.dist.halo.HaloPlan`.

    ``e`` is the host EHYB the plan was built from; without it only the
    internal accounting is checkable (coverage needs the live entry set).
    """
    out: List[Finding] = []
    site = "HaloPlan"
    n_dev, S = hp.n_dev, hp.seg_len
    cf = np.asarray(hp.counts_fetch)
    cp = np.asarray(hp.counts_push)
    dirs = np.asarray(hp.direction)

    # ---- accounting -------------------------------------------------------
    if hp.halo_words != int(cf.sum() + cp.sum()):
        out.append(_f("error", site, "halo-accounting",
                      f"halo_words={hp.halo_words} != scheduled payload "
                      f"{int(cf.sum() + cp.sum())}"))
    if hp.buffer_words != n_dev * n_dev * S:
        out.append(_f("error", site, "halo-accounting",
                      f"buffer_words={hp.buffer_words} != n_dev²·seg_len="
                      f"{n_dev * n_dev * S}"))
    per_dev = cf.sum(axis=1) + cp.sum(axis=1)
    if not np.array_equal(np.asarray(hp.per_device_words), per_dev):
        out.append(_f("error", site, "halo-accounting",
                      "per_device_words do not match the per-device "
                      "fetch+push counts"))
    if np.any((dirs == 1) & (cp > 0)) or np.any((dirs == 2) & (cf > 0)):
        out.append(_f("error", site, "halo-accounting",
                      "fetch/push counts recorded against the opposite "
                      "direction"))
    if int(np.maximum(cf, cp).max(initial=0)) > S:
        out.append(_f("error", site, "halo-accounting",
                      "a pair's payload exceeds the all_to_all segment "
                      "length"))

    # ---- schedule layout + push-race check (plan-internal) ----------------
    rp_sel = np.asarray(hp.rp_sel)
    rp_rows = np.asarray(hp.rp_rows)
    rp_mask = np.asarray(hp.rp_mask)
    recv_sel = np.asarray(hp.recv_sel)
    for d in range(n_dev):
        fpos = 0
        for s in range(n_dev):
            if dirs[d, s] != 1:
                continue
            k = int(cf[d, s])
            if not np.array_equal(
                    recv_sel[d, fpos:fpos + k],
                    s * S + np.arange(k, dtype=recv_sel.dtype)):
                out.append(_f("error", f"{site}.recv[{d}<-{s}]",
                              "halo-coverage",
                              "recv_sel does not address the source's "
                              "fetch segment contiguously"))
            fpos += k
        if recv_sel.shape[1] < fpos:
            out.append(_f("error", f"{site}.recv[{d}]", "halo-coverage",
                          "fetched-halo buffer shorter than the scheduled "
                          "fetch counts"))
        pos = 0
        for s in range(n_dev):
            if dirs[d, s] != 2:
                continue
            k = int(cp[d, s])
            blk = slice(pos, pos + k)
            if not rp_mask[d, blk].all():
                out.append(_f("error", f"{site}.rp[{d}<-{s}]",
                              "halo-coverage",
                              "receive-push block shorter than the "
                              "recorded count"))
            if not np.array_equal(rp_sel[d, blk],
                                  s * S + np.arange(k, dtype=rp_sel.dtype)):
                out.append(_f("error", f"{site}.rp[{d}<-{s}]",
                              "halo-coverage",
                              "rp_sel does not address the source's "
                              "segment contiguously"))
            rows_blk = rp_rows[d, blk]
            if len(np.unique(rows_blk)) != k:
                out.append(_f("error", f"{site}.rp[{d}<-{s}]",
                              "halo-push-race",
                              f"duplicate scatter-add destination row in "
                              f"the push segment from device {s} — a data "
                              f"race under parallel lowering"))
            pos += k
        if rp_mask[d, pos:].any():
            out.append(_f("error", f"{site}.rp[{d}]", "halo-coverage",
                          "masked receive-push slots beyond the scheduled "
                          "segments"))

    if e is None:
        out.append(_f("info", site, "halo-coverage",
                      "no source EHYB supplied; entry-coverage laws not "
                      "checked"))
        return out

    # ---- exact coverage against the live entry set ------------------------
    from ..dist.halo import _live_entries

    if hp.n_pad != e.n_pad:
        out.append(_f("error", site, "halo-accounting",
                      f"plan built for n_pad={hp.n_pad}, matrix has "
                      f"n_pad={e.n_pad}"))
        return out
    rows, cols, src = _live_entries(e)
    L = hp.local_size
    own_r, own_c = rows // L, cols // L
    off = own_r != own_c
    if hp.allgather_words != 2 * n_dev * e.n_pad:
        out.append(_f("error", site, "halo-accounting",
                      "allgather_words baseline does not match "
                      "2·n_dev·n_pad"))

    is_push = off & (dirs[own_r, own_c] == 2)
    # every live entry lands in exactly one table: fer (fetch side, incl.
    # local) or pe (push side)
    pe_src = np.asarray(hp.pe_src)[np.asarray(hp.pe_mask)]
    covered = np.concatenate([np.asarray(hp.fer_src), pe_src])
    if not np.array_equal(np.sort(covered), np.sort(src)):
        dup = len(covered) - len(np.unique(covered))
        out.append(_f("error", site, "halo-coverage",
                      f"fer/pe tables cover {len(covered)} entry slots "
                      f"({dup} duplicated) but the live pattern has "
                      f"{len(src)} — some ER reference is dropped or "
                      f"double-counted"))
    if not np.array_equal(np.sort(pe_src), np.sort(src[is_push])):
        out.append(_f("error", site, "halo-coverage",
                      "push-side entries do not match the entries of "
                      "push-direction pairs exactly once"))
    fer_dst = np.asarray(hp.fer_dst)
    if len(np.unique(fer_dst)) != len(fer_dst):
        out.append(_f("error", site, "halo-coverage",
                      "duplicate destinations in the fetch-side ER table"))

    # per-pair fetch segments carry exactly the unique remote columns
    send_idx = np.asarray(hp.send_idx)
    send_mask = np.asarray(hp.send_mask)
    for d in range(n_dev):
        for s in range(n_dev):
            if d == s:
                continue
            sel = off & (own_r == d) & (own_c == s)
            if dirs[d, s] == 1:
                want = np.unique(cols[sel]) - s * L
                k = int(cf[d, s])
                got = send_idx[s, d][send_mask[s, d]]
                if k != len(want) or not np.array_equal(np.sort(got),
                                                        want):
                    out.append(_f(
                        "error", f"{site}.fetch[{d}<-{s}]", "halo-coverage",
                        f"fetch segment carries {len(got)} column(s), "
                        f"expected the {len(want)} unique remote columns"))
            elif dirs[d, s] == 2:
                want_rows = np.unique(rows[sel]) - d * L
                k = int(cp[d, s])
                if k != len(want_rows):
                    out.append(_f(
                        "error", f"{site}.push[{d}<-{s}]", "halo-coverage",
                        f"push segment schedules {k} row(s), expected "
                        f"{len(want_rows)} distinct destination rows"))
            elif sel.any():
                out.append(_f("error", f"{site}.pair[{d},{s}]",
                              "halo-coverage",
                              f"{int(sel.sum())} cross-device entries on a "
                              f"pair with no scheduled direction"))
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

# registered-format name -> device-container checker (the default
# ``FormatSpec.invariants`` hooks route here; external formats register
# their own hook instead)
_BY_FORMAT = {
    "csr": check_coo_device,
    "ell": check_ell_device,
    "hyb": check_hyb_device,
    "ehyb": check_ehyb_device,
    "ehyb_bucketed": check_buckets_device,
    "ehyb_packed": check_packed_device,
    "dense": check_dense,
}


def format_invariants(name: str, obj, host=None) -> List[Finding]:
    """The built-in invariant checks for registered format ``name`` —
    what the default ``FormatSpec.invariants`` hooks delegate to.
    ``host`` is the host EHYB build an EHYB-family container was bound
    from (None: the container is checked on its own)."""
    try:
        checker = _BY_FORMAT[name]
    except KeyError:
        raise KeyError(f"no built-in invariants for format {name!r}; "
                       f"register a FormatSpec.invariants hook") from None
    return checker(obj, host)


def _check_pattern(m) -> List[Finding]:
    out: List[Finding] = []
    indptr = np.asarray(m.indptr)
    if indptr[0] != 0 or np.any(np.diff(indptr) < 0):
        out.append(_f("error", "SparseCSR.indptr", "index-bound.stream",
                      "indptr is not a monotone row-pointer array"))
    _bound(out, "SparseCSR", "indices", m.indices, m.n,
           "index-bound.stream")
    _finite(out, "SparseCSR", "data", m.data)
    return out


def verify(obj) -> List[Finding]:
    """Statically verify a container/operator; [] means every rule passed.

    Accepts host builds (``EHYB``, ``PackedEHYB``, ``EHYBBuckets``), raw
    :class:`~repro_torch.core.partition.Partition` objects, any registered
    device container, ``SparseCSR`` patterns, and bound
    :class:`~repro_torch.api.LinearOperator` s — an operator dispatches
    through its format's ``FormatSpec.invariants`` hook with the plan's
    host build (EHYB family), which is then checked as well.
    """
    from ..core.ehyb import EHYB, EHYBBuckets, PackedEHYB
    from ..core.matrices import SparseCSR
    from ..core.partition import Partition

    if isinstance(obj, SparseCSR):
        return _check_pattern(obj)
    if isinstance(obj, Partition):
        return check_partition(obj)
    if isinstance(obj, PackedEHYB):
        return check_packed_host(obj)
    if isinstance(obj, EHYBBuckets):
        return check_buckets_host(obj)
    if isinstance(obj, EHYB):
        return check_ehyb_host(obj)

    from ..api.operator import LinearOperator
    from ..core.spmv import (COODevice, DenseDevice, EHYBBucketsDevice,
                             EHYBDevice, EHYBPackedDevice, ELLDevice,
                             HYBDevice)

    from ..dist.operator import EHYBShards, ShardedOperator

    if isinstance(obj, LinearOperator) and obj.plan.is_sharded:
        eng = obj.plan._engine(obj)
        out = check_shards_device(obj.obj)
        out += check_halo_plan(eng.plan, eng.host_ehyb)
        return out + check_ehyb_host(eng.host_ehyb)
    if isinstance(obj, ShardedOperator):
        return (check_shards_device(obj.obj)
                + check_halo_plan(obj.plan, obj.host_ehyb))
    if isinstance(obj, EHYBShards):
        return check_shards_device(obj)
    if isinstance(obj, LinearOperator):
        from ..autotune.registry import get_format

        spec = get_format(obj.plan.format)
        host = obj.plan._shared.get("ehyb") if spec.partitioned else None
        out = list(spec.invariants(obj.obj, host) if spec.invariants
                   is not None else verify(obj.obj))
        if host is not None:
            out += check_ehyb_host(host)
        return out
    for cls, checker in ((EHYBDevice, check_ehyb_device),
                         (EHYBPackedDevice, check_packed_device),
                         (EHYBBucketsDevice, check_buckets_device),
                         (COODevice, check_coo_device),
                         (ELLDevice, check_ell_device),
                         (HYBDevice, check_hyb_device),
                         (DenseDevice, check_dense)):
        if isinstance(obj, cls):
            return checker(obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)) and obj.ndim == 2:
        return check_dense(obj)
    raise TypeError(f"verify() does not know how to check "
                    f"{type(obj).__name__}")


def verify_plan(plan, ehyb=None) -> List[Finding]:
    """Verify the pattern-only planning layer.

    ``plan`` may be a :class:`repro_torch.dist.HaloPlan` (pass ``ehyb``,
    the host build it was planned from, for the entry-coverage laws) or a
    :class:`repro_torch.api.Plan`: its pattern, its partition (which may
    have come from the tune store), once built its host EHYB and, for a
    sharded plan, the halo schedule of each bound engine."""
    from ..api.plan import Plan
    from ..dist.halo import HaloPlan

    if isinstance(plan, HaloPlan):
        return check_halo_plan(plan, ehyb)
    if not isinstance(plan, Plan):
        raise TypeError(f"verify_plan() takes a repro_torch.api.Plan or a "
                        f"dist HaloPlan, got {type(plan).__name__}")
    out = _check_pattern(plan.pattern)
    if plan.partition is not None:
        out += check_partition(plan.partition)
    host = plan._shared.get("ehyb")
    if host is not None:
        out += check_ehyb_host(host)
    for eng, _ in plan._templates.values():
        out += check_halo_plan(eng.plan, eng.host_ehyb)
    return out
