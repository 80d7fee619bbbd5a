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
    findings = verify_plan(plan)    # a repro_torch.api.Plan

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

The reference's ``halo-coverage``, ``halo-push-race`` and
``halo-accounting`` rules (``check_halo_plan``, ``check_shards_device``)
check the distributed operator and come with ``dist/``.

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
    "value-finite", "bucket-cover",
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


def verify_plan(plan) -> List[Finding]:
    """Verify the pattern-only planning layer of a
    :class:`repro_torch.api.Plan`: its pattern, its partition (which may
    have come from the tune store) and, once built, its host EHYB."""
    from ..api.plan import Plan

    if not isinstance(plan, Plan):
        raise TypeError(f"verify_plan() takes a repro_torch.api.Plan, got "
                        f"{type(plan).__name__}")
    out = _check_pattern(plan.pattern)
    if plan.partition is not None:
        out += check_partition(plan.partition)
    host = plan._shared.get("ehyb")
    if host is not None:
        out += check_ehyb_host(host)
    return out
