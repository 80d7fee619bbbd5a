"""ShardedOperator — the operator, distributed over a process group.

The port of ``repro.dist.operator`` onto ``torch.distributed``, one process
a device (SPMD): every rank builds the same host EHYB and the same
:class:`~repro_torch.dist.halo.HaloPlan`, and holds only its own shard.

* the sliced-ELL part is **communication-free**: each rank holds the ELL
  tiles of its ``parts_per_dev`` partitions and the matching x shard (the
  paper's explicitly cached slice, resident on its device) and runs them
  through the uniform ELL-only kernels (#4 ``ehyb_ell`` at one right-hand
  side, #9 ``ehyb_ell_spmm`` at K ≥ 2, routed as ``kernels.ops`` routes
  them);
* the ER part exchanges exactly the planned halo through one
  ``all_to_all_single`` per SpMV (fetch segments carry remote x words, push
  segments partial-y sums), then runs the rank's fetch-side ER table, whose
  columns index the compact local space ``[0, local_size + halo)``, through
  the ER kernel (#6 ``er``) and adds its rows in; the pushed partial sums
  are added with ``index_add_``.

The host plan keeps the reference's arrays bit for bit.  On the device each
rank keeps only its live entries: its fetch table is cut to its live rows,
width-sorted (``halo.fetch_layout``: #6 reads each row's live prefix and
needs non-increasing widths), and its send, push and receive tables are cut
to their masked slots.  A padded slot is never read, so a non-finite x
never spreads through one.

**Spaces under SPMD.**  The original-space ``op(x)`` takes the replicated
global x on every rank and returns the replicated global y (one
``all_gather`` of the y shards), as the reference's caller sees a global
array.  The permuted space carries each rank's ``(local_size[, R])`` shard,
so a solver's hot loop moves only halo words; ``from_permuted`` gathers the
shards back into a global vector.

``_local_apply`` receives the exchange as a function: the package passes
the collective on the operator's group (:func:`group_exchange`), and
:func:`replay_apply` runs every rank's shard in one process with the
exchange replayed by indexing the stacked send buffers.  On the card the
applies launch the kernels or raise; :func:`local_apply_plain` is the same
stages on the kernels' plain versions, for validation only.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, ClassVar, Optional

import numpy as np
import torch

from ..core.counters import bump
from ..core.ehyb import EHYB, EHYBBuckets
from ..core.matrices import SparseCSR
from ..core.spmv import EHYBDevice, _acc_dtype, _as_2d, _from_permuted, \
    _tensor, column_rows
from ..kernels import ref as _ref
from .halo import HaloPlan, build_halo_plan, fetch_layout


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def mesh_axis_info(mesh, axis: str = "data") -> tuple:
    """``(group, n_dev, rank, device)`` of ``mesh[axis]``: the process group
    of the axis, its size, this process's coordinate on it and its device
    (``cuda:<local rank>`` on a ``"cuda"`` mesh, ``cpu`` on a ``"cpu"``
    one)."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}; it has {names}")
    dim = names.index(axis)
    group = mesh.get_group(axis)
    n_dev = mesh.size(dim)
    rank = mesh.get_local_rank(axis)
    if mesh.device_type == "cuda":
        from ..api.plan import resolve_device

        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % max(torch.cuda.device_count(), 1)))
        device = resolve_device(torch.device("cuda", local))
    elif mesh.device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"the port runs on 'cuda' or 'cpu' meshes, not "
                         f"{mesh.device_type!r}")
    return group, n_dev, rank, device


# ---------------------------------------------------------------------------
# device container: one rank's shard
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class EHYBShards:
    """One rank's tables of a sharded EHYB operator (the reference's
    ``EHYBShards`` holds all ranks' with a leading ``n_dev`` axis; here a
    rank holds only its slice ``[rank]``, cut to its live entries).  The
    permutations stay whole on every rank."""

    n: int
    n_pad: int                # n_pad_dist = n_dev * local_size
    n_parts: int              # padded partition count (n_dev * ppd)
    vec_size: int
    n_dev: int
    rank: int
    local_size: int
    seg_len: int              # S: all_to_all segment length
    has_er: bool
    needs_comm: bool
    has_push: bool
    ell_vals: torch.Tensor    # (ppd, V, W)
    ell_cols: torch.Tensor    # (ppd, V, W) uint16 local
    col_rows: torch.Tensor    # (ppd, W) int32 rows per ELL column
    fer_vals: torch.Tensor    # (Rd, Wd) width-sorted fetch-side ER table
    fer_cols: torch.Tensor    # (Rd, Wd) int32 compact [0, L + Hd)
    fer_col_rows: torch.Tensor  # (Wd,) int32 rows per fetch-table column
    fer_rows: torch.Tensor    # (Rd,) int64 local row, unique
    pe_vals: torch.Tensor     # (PEd,) push entries of this rank
    pe_cols: torch.Tensor     # (PEd,) int64 local column
    pe_dst: torch.Tensor      # (PEd,) int64 flat slot into (n_dev*S)
    send_pos: torch.Tensor    # (Fd,) int64 flat slot into (n_dev*S)
    send_src: torch.Tensor    # (Fd,) int64 local x index
    recv_sel: torch.Tensor    # (Hd,) int64 flat index into (n_dev*S) recv
    rp_sel: torch.Tensor      # (PRd,) int64 flat index into (n_dev*S) recv
    rp_rows: torch.Tensor     # (PRd,) int64 local destination row
    perm: torch.Tensor        # (n_pad_dist,) int64
    inv_perm: torch.Tensor    # (n_pad_dist,) int64
    group: Any = None         # the mesh axis's process group
    VALUE_FIELDS: ClassVar[tuple] = ("ell_vals", "fer_vals", "pe_vals")

    @property
    def local_perm(self) -> torch.Tensor:
        """The original index of each of this rank's permuted slots."""
        lo = self.rank * self.local_size
        return self.perm[lo: lo + self.local_size]


def _rank_layout(e: EHYB, hp: HaloPlan, rank: int) -> dict:
    """Host index arrays of ``rank``'s shard (pattern-only): its partition
    range with the padding, its width-sorted fetch table, and its cut
    send/push/receive tables, with the ER-value gathers of a refill."""
    ppd = hp.parts_per_dev
    lo = rank * ppd
    hi = max(lo, min(lo + ppd, e.n_parts))
    fl = fetch_layout(hp, rank)
    pm = hp.pe_mask[rank]
    sm = hp.send_mask[rank].reshape(-1)
    send_pos = np.flatnonzero(sm)
    rm = hp.rp_mask[rank]
    return {"lo": lo, "hi": hi, "pad": ppd - (hi - lo), "fetch": fl,
            "pe_cols": hp.pe_cols[rank][pm].astype(np.int64),
            "pe_dst": hp.pe_dst[rank][pm].astype(np.int64),
            "pe_src": hp.pe_src[rank][pm].astype(np.int64),
            "send_pos": send_pos.astype(np.int64),
            "send_src": hp.send_idx[rank].reshape(-1)[send_pos].astype(
                np.int64),
            "recv_sel": hp.recv_sel[rank][: int(hp.counts_fetch[rank].sum())
                                          ].astype(np.int64),
            "rp_sel": hp.rp_sel[rank][rm].astype(np.int64),
            "rp_rows": hp.rp_rows[rank][rm].astype(np.int64)}


def _pad_parts(a: np.ndarray, lay: dict) -> np.ndarray:
    part = a[lay["lo"]: lay["hi"]]
    if lay["pad"]:
        part = np.concatenate(
            [part, np.zeros((lay["pad"],) + a.shape[1:], a.dtype)], axis=0)
    return part


def _value_tables(e: EHYB, lay: dict) -> dict:
    """The rank's value tables from host build ``e`` (float64 host)."""
    fl = lay["fetch"]
    fer = np.zeros(fl["cols"].size, dtype=np.float64)
    er_flat = np.asarray(e.er_vals, dtype=np.float64).reshape(-1)
    fer[fl["dst"]] = er_flat[fl["src"]]
    return {"ell_vals": _pad_parts(e.ell_vals, lay),
            "fer_vals": fer.reshape(fl["cols"].shape),
            "pe_vals": er_flat[lay["pe_src"]]}


def _shards_from_ehyb(e: EHYB, hp: HaloPlan, dtype, device, rank: int,
                      group=None) -> tuple:
    """``(EHYBShards, layout)`` of ``rank`` from host build ``e`` and its
    plan ``hp`` (the rank's view of the reference's ``_shards_from_ehyb``,
    the padding of empty partitions when ``n_parts % n_dev != 0``
    included)."""
    dt = dtype or torch.float32
    lay = _rank_layout(e, hp, rank)
    vals = _value_tables(e, lay)
    fl = lay["fetch"]
    N = hp.n_pad_dist
    perm = np.concatenate([e.perm, np.arange(e.n_pad, N)])
    inv_perm = np.concatenate([e.inv_perm, np.arange(e.n_pad, N)])

    def t(a, dtype_=None):
        return _tensor(np.asarray(a), device, dtype_)

    obj = EHYBShards(
        n=e.n, n_pad=N, n_parts=hp.n_parts_pad, vec_size=e.vec_size,
        n_dev=hp.n_dev, rank=rank, local_size=hp.local_size,
        seg_len=hp.seg_len, has_er=hp.has_er, needs_comm=hp.needs_comm,
        has_push=hp.has_push,
        ell_vals=t(vals["ell_vals"], dt),
        ell_cols=t(_pad_parts(e.ell_cols, lay)),
        col_rows=t(_pad_parts(column_rows(e), lay)),
        fer_vals=t(vals["fer_vals"], dt), fer_cols=t(fl["cols"]),
        fer_col_rows=t(fl["col_rows"]), fer_rows=t(fl["fer_rows"]),
        pe_vals=t(vals["pe_vals"], dt), pe_cols=t(lay["pe_cols"]),
        pe_dst=t(lay["pe_dst"]), send_pos=t(lay["send_pos"]),
        send_src=t(lay["send_src"]), recv_sel=t(lay["recv_sel"]),
        rp_sel=t(lay["rp_sel"]), rp_rows=t(lay["rp_rows"]),
        perm=t(perm.astype(np.int64)), inv_perm=t(inv_perm.astype(np.int64)),
        group=group)
    return obj, lay


def shard_value_index(e: EHYB, lay: dict) -> dict:
    """Where each nonzero's value goes in the rank's value tables:
    ``{field: (dst, src)}`` for each of ``EHYBShards.VALUE_FIELDS``, flat
    positions in the rank's table and CSR positions in the value stream
    (host int64).  Composed from the build's ``fill_plan`` and the rank's
    ``layout`` (its partition range with the padding, the fetch table's
    ``dst``/``src``, ``pe_src``), so it is pattern-only and holds for
    every bind of the pattern: scattering a value stream through it gives
    the tables :func:`_value_tables` makes of the refilled build."""
    if e.fill_plan is None:
        raise ValueError("this sharded operator carries no host fill plan "
                         "(a build recovered from a bare EHYBDevice); bind "
                         "host values or rebuild from the SparseCSR")
    fp = e.fill_plan
    tile = e.vec_size * e.ell_width
    ell_dst = np.asarray(fp["ell_dst"], dtype=np.int64)
    part = ell_dst // tile
    mine = (part >= lay["lo"]) & (part < lay["hi"])
    # the ER table's flat slot -> its CSR position (-1: an empty slot)
    er_src = np.full(e.er_rows * e.er_width, -1, dtype=np.int64)
    er_src[np.asarray(fp["er_dst"], dtype=np.int64)] = fp["er_src"]
    fl = lay["fetch"]
    f_src = er_src[np.asarray(fl["src"], dtype=np.int64)]
    f_live = f_src >= 0
    p_src = er_src[lay["pe_src"]]
    p_live = p_src >= 0
    return {"ell_vals": (ell_dst[mine] - lay["lo"] * tile,
                         np.asarray(fp["ell_src"], dtype=np.int64)[mine]),
            "fer_vals": (np.asarray(fl["dst"], dtype=np.int64)[f_live],
                         f_src[f_live]),
            "pe_vals": (np.flatnonzero(p_live), p_src[p_live])}


def scatter_shards(obj: EHYBShards, vals: torch.Tensor,
                   index: dict) -> EHYBShards:
    """``obj`` with its value tables scattered on the device from the
    per-nnz ``vals`` (CSR order, the tables' dtype, on the rank's device)
    through ``index`` (:func:`shard_value_index`, on the device): three
    scatters into zeros, every structural tensor shared by reference."""
    tables = {}
    for f in EHYBShards.VALUE_FIELDS:
        dst, src = index[f]
        shape = getattr(obj, f).shape
        flat = vals.new_zeros(math.prod(shape))
        tables[f] = flat.index_copy_(0, dst, vals.index_select(0, src)
                                     ).reshape(shape)
    return dataclasses.replace(obj, **tables)


def _refill_shards(obj: EHYBShards, e_new: EHYB, lay: dict,
                   dtype) -> EHYBShards:
    """Value tables only, from the refilled host build ``e_new``; every
    structural tensor shared by reference."""
    dt = dtype or torch.float32
    vals = _value_tables(e_new, lay)
    dev = obj.ell_vals.device
    return dataclasses.replace(
        obj, **{f: _tensor(v, dev, dt) for f, v in vals.items()})


# ---------------------------------------------------------------------------
# the per-rank apply
# ---------------------------------------------------------------------------

def _ell_kernel(obj: EHYBShards, x_parts: torch.Tensor) -> torch.Tensor:
    from ..kernels.ops import _ell_uniform

    return _ell_uniform(obj, x_parts)


def _ell_plain(obj: EHYBShards, x_parts: torch.Tensor) -> torch.Tensor:
    return _ref.ehyb_ell_ref(x_parts, obj.ell_vals, obj.ell_cols,
                             obj.col_rows)


def _er_kernel(x_ext, vals, cols, col_rows) -> torch.Tensor:
    from ..kernels.ehyb_spmv import er

    return er(x_ext, vals, cols, col_rows)


def _send_buffer(obj: EHYBShards, x_loc: torch.Tensor) -> torch.Tensor:
    """The ``(n_dev·S, R)`` all_to_all payload, segment ``d`` bound for
    rank ``d``: this rank's x words each fetching rank needs, plus its
    partial-y sums for the ranks it pushes to (in the accumulation dtype;
    unused slots stay 0)."""
    r = x_loc.shape[1]
    acc = _acc_dtype(x_loc.dtype)
    buf = x_loc.new_zeros((obj.n_dev * obj.seg_len, r), dtype=acc)
    buf.index_copy_(0, obj.send_pos,
                    x_loc.index_select(0, obj.send_src).to(acc))
    if obj.pe_dst.numel():
        contrib = obj.pe_vals[:, None].to(acc) * x_loc.index_select(
            0, obj.pe_cols).to(acc)
        buf.index_add_(0, obj.pe_dst, contrib)
    return buf


def _local_apply(obj: EHYBShards, x_loc: torch.Tensor,
                 exchange: Optional[Callable], *, ell=_ell_kernel,
                 er=_er_kernel) -> torch.Tensor:
    """One rank's y shard ``(local_size, R)`` from its x shard ``x_loc``
    ``(local_size, R)`` (the tables' dtype): the local ELL tiles, the
    planned exchange (``exchange(send) -> recv``, both ``(n_dev·S, R)``;
    skipped statically when no pair communicates), the fetch-side ER table
    on ``x_ext = [x_loc, halo]`` and the received partial sums."""
    r = x_loc.shape[1]
    ppd = obj.ell_vals.shape[0]
    y = ell(obj, x_loc.reshape(ppd, obj.vec_size, r)).reshape(
        obj.local_size, r)
    if not obj.has_er:
        return y
    recv = exchange(_send_buffer(obj, x_loc)) if obj.needs_comm else None
    acc = _acc_dtype(x_loc.dtype)
    y = y.to(acc)
    if obj.fer_rows.numel():
        x_ext = x_loc if recv is None else torch.cat(
            [x_loc, recv.index_select(0, obj.recv_sel).to(x_loc.dtype)])
        part = er(x_ext, obj.fer_vals, obj.fer_cols, obj.fer_col_rows)
        y.index_add_(0, obj.fer_rows, _as_2d(part)[0].to(acc))
    if recv is not None and obj.rp_rows.numel():
        y.index_add_(0, obj.rp_rows, recv.index_select(0, obj.rp_sel))
    return y.to(x_loc.dtype)


def local_apply_plain(obj: EHYBShards, x_loc: torch.Tensor,
                      exchange: Optional[Callable]) -> torch.Tensor:
    """:func:`_local_apply` on the kernels' plain versions
    (``kernels.ref``), whatever the device: for validation."""
    return _local_apply(obj, x_loc, exchange, ell=_ell_plain,
                        er=_ref.er_live_ref)


def group_exchange(group) -> Callable:
    """The exchange of a process group: one ``all_to_all_single``."""
    import torch.distributed as dist

    def exchange(buf: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf.contiguous(), group=group)
        return out
    return exchange


def replay_apply(shards: list, x_locs: list, *,
                 plain: bool = False) -> list:
    """Every rank's shard of one operator applied in one process, the
    exchange replayed by indexing: rank ``d`` receives segment ``d`` of
    every rank's send buffer, stacked.  ``shards[d]`` and ``x_locs[d]``
    ``(local_size[, R])`` are rank ``d``'s; returns the y shards, shaped as
    the x shards."""
    fn = local_apply_plain if plain else _local_apply
    first = shards[0]
    squeeze = x_locs[0].dim() == 1
    xs = [_as_2d(x)[0] for x in x_locs]
    if first.has_er and first.needs_comm:
        s = first.seg_len
        sent = torch.stack([_send_buffer(o, x).reshape(first.n_dev, s, -1)
                            for o, x in zip(shards, xs)])  # (src, dst, S, R)
        ys = [fn(o, x, lambda buf, d=d: sent[:, d].reshape(buf.shape))
              for d, (o, x) in enumerate(zip(shards, xs))]
    else:
        ys = [fn(o, x, None) for o, x in zip(shards, xs)]
    return [y[:, 0] for y in ys] if squeeze else ys


def _all_gather(obj: EHYBShards, y_loc: torch.Tensor) -> torch.Tensor:
    """The ``(n_pad_dist, R)`` permuted y from every rank's shard."""
    import torch.distributed as dist

    out = y_loc.new_empty((obj.n_pad, y_loc.shape[1]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, y_loc.contiguous(), group=obj.group)
    return out


def shard_of(obj: EHYBShards, x: torch.Tensor) -> torch.Tensor:
    """Original-space x ``(n[, R])`` -> this rank's permuted shard
    ``(local_size[, R])``."""
    x2, squeeze = _as_2d(x)
    pad = x2.new_zeros((obj.n_pad - obj.n, x2.shape[1]))
    xs = torch.cat([x2, pad]).index_select(0, obj.local_perm)
    return xs[:, 0] if squeeze else xs


def gather_original(obj: EHYBShards, y_loc: torch.Tensor) -> torch.Tensor:
    """This rank's permuted shard ``(local_size[, R])`` -> the global
    original-space y ``(n[, R])``, the same on every rank."""
    y2, squeeze = _as_2d(y_loc)
    return _from_permuted(obj, _all_gather(obj, y2), squeeze)


def sharded_apply_permuted(obj: EHYBShards,
                           x_loc: torch.Tensor) -> torch.Tensor:
    """``y_loc = (A x)[rank's slots]`` from the rank's shard (the solver's
    matvec): ``(local_size[, R])`` in and out."""
    x2, squeeze = _as_2d(x_loc)
    y = _local_apply(obj, x2, group_exchange(obj.group))
    return y[:, 0] if squeeze else y


def sharded_apply(obj: EHYBShards, x: torch.Tensor) -> torch.Tensor:
    """``y = A x`` in the original space: the replicated global x ``(n[,
    R])`` in, the replicated global y out."""
    x2, squeeze = _as_2d(x)
    y = _local_apply(obj, shard_of(obj, x2), group_exchange(obj.group))
    return _from_permuted(obj, _all_gather(obj, y), squeeze)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ShardedOperator:
    """A sparse operator sharded over ``mesh[axis]``: this rank's engine.

    The lifecycle and space API of the local operators — ``op(x)`` in the
    original space, ``to_permuted``/``matvec_permuted``/``from_permuted``
    for hot loops, ``update_values(a_new)`` a refill with zero re-planning
    (the halo plan is pattern-only).  Every rank calls each method with the
    same arguments (SPMD)."""

    format: str               # base format the operator was sharded from
    obj: EHYBShards
    mesh: Any
    axis: str
    n: int
    nnz: int
    plan: HaloPlan
    host_ehyb: Optional[EHYB] = None
    csr: Optional[SparseCSR] = None       # host matrix (solve preconditioner)
    dtype: Any = None
    pattern_key: Optional[str] = None
    tuning: Any = None
    layout: Optional[dict] = None         # the rank's host index arrays
    # shard_value_index on the device, made at the first tensor refill
    value_index: Optional[dict] = dataclasses.field(default=None,
                                                    repr=False)

    apply = staticmethod(sharded_apply)
    apply_permuted = staticmethod(sharded_apply_permuted)

    @property
    def device(self) -> torch.device:
        return self.obj.perm.device

    def _promote(self, x) -> torch.Tensor:
        """x as a tensor on the rank's device in the value dtype (a
        non-float rhs never drives integer math against the tables)."""
        return torch.as_tensor(x, device=self.device).to(
            self.dtype or torch.float32)

    def __call__(self, x) -> torch.Tensor:
        return self.apply(self.obj, self._promote(x))

    @property
    def matvec(self):
        return self.__call__

    # ---- permuted space ----------------------------------------------------

    @property
    def supports_permuted(self) -> bool:
        return True

    @property
    def n_pad(self) -> int:
        return self.obj.n_pad

    @property
    def local_size(self) -> int:
        return self.obj.local_size

    def to_permuted(self, x) -> torch.Tensor:
        return shard_of(self.obj, self._promote(x))

    def from_permuted(self, y_loc) -> torch.Tensor:
        return gather_original(self.obj, torch.as_tensor(
            y_loc, device=self.device))

    def _permuted_call(self, x_loc) -> torch.Tensor:
        return self.apply_permuted(self.obj, self._promote(x_loc))

    @property
    def matvec_permuted(self):
        return self._permuted_call

    @property
    def perm_host(self) -> np.ndarray:
        return self.obj.perm.cpu().numpy()

    # ---- value refresh -----------------------------------------------------

    def device_value_index(self) -> dict:
        """:func:`shard_value_index` of this rank on its device (made once
        and carried to the operators :meth:`update_values` returns)."""
        if self.value_index is None:
            if self.host_ehyb is None:
                raise ValueError("this sharded operator carries no host "
                                 "build to index its value tables from")
            self.value_index = {
                f: tuple(torch.from_numpy(a).to(self.device) for a in ds)
                for f, ds in shard_value_index(self.host_ehyb,
                                               self.layout).items()}
        return self.value_index

    def update_values(self, a_new, *,
                      pattern: Optional[str] = None) -> "ShardedOperator":
        """Same sparsity pattern, new values.  A :class:`SparseCSR`: the
        host build refilled (``EHYB.refill``) and the rank's value tables
        filled through its recorded layout and uploaded.  A ``(nnz,)``
        tensor (CSR order): three scatters on the device through
        :meth:`device_value_index`, no host copy.  Zero partitioning, zero
        build, zero halo re-planning; every structural tensor shared."""
        from ..autotune.cost import pattern_hash

        if self.host_ehyb is None or self.host_ehyb.fill_plan is None:
            raise ValueError("this sharded operator carries no host fill "
                             "plan; rebuild with build_sharded_spmv")
        if isinstance(a_new, torch.Tensor):
            if tuple(a_new.shape) != (self.nnz,):
                raise ValueError(f"update_values takes a ({self.nnz},) "
                                 f"per-nnz tensor (CSR order); got shape "
                                 f"{tuple(a_new.shape)}")
            vals = a_new.detach().to(self.device, self.dtype)
            obj = scatter_shards(self.obj, vals, self.device_value_index())
            return dataclasses.replace(self, obj=obj, csr=None)
        if a_new.n != self.n or a_new.nnz != self.nnz or (
                self.pattern_key is not None
                and (pattern or pattern_hash(a_new)) != self.pattern_key):
            raise ValueError(
                "update_values needs a matrix with the identical sparsity "
                "pattern; build a fresh sharded operator for a new pattern")
        e_new = self.host_ehyb.refill(a_new.data)
        obj = _refill_shards(self.obj, e_new, self.layout, self.dtype)
        return dataclasses.replace(self, obj=obj, host_ehyb=e_new, csr=a_new)

    # ---- the distributed solver --------------------------------------------

    def solver_runner(self, method: str) -> Callable:
        """``run(obj, b_loc, x0_loc, inv_loc, tol, max_iters, **guards)`` —
        the Krylov loop on this rank's shards: the matvec is the local apply
        with the halo exchange, every dot ``all_reduce``-d over the group.
        Returns the rank's result (``x`` its shard; the scalars the same on
        every rank)."""
        from ..core.solver import SOLVERS

        solver = SOLVERS[method]

        def run(obj, b_loc, x0_loc, inv_loc, tol, max_iters, **kw):
            exchange = group_exchange(obj.group)

            def mv(v):
                return _local_apply(obj, v[:, None], exchange)[:, 0]

            pre = None if inv_loc is None else (lambda r: inv_loc * r)
            return solver(mv, b_loc, pre, tol=tol, max_iters=max_iters,
                          x0=x0_loc, group=obj.group, **kw)
        return run


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _from_host(e: EHYB, mesh, axis: str, fmt: str, dtype, *,
               csr: Optional[SparseCSR] = None, pattern_key=None,
               tuning=None) -> ShardedOperator:
    group, n_dev, rank, device = mesh_axis_info(mesh, axis)
    hp = build_halo_plan(e, n_dev)
    obj, lay = _shards_from_ehyb(e, hp, dtype, device, rank, group)
    return ShardedOperator(
        format=fmt, obj=obj, mesh=mesh, axis=axis, n=e.n, nnz=e.nnz,
        plan=hp, host_ehyb=e, csr=csr, dtype=dtype or torch.float32,
        pattern_key=pattern_key, tuning=tuning, layout=lay)


def ehyb_from_device(dev: EHYBDevice) -> EHYB:
    """Pseudo host EHYB reconstructed from a bare device container (the
    legacy ``build_dist_spmv`` path): no fill plan, so the live ER set
    falls back to the nonzero mask (``halo``) and value refills are
    unavailable (``update_values`` raises)."""
    def host(t):
        return t.detach().cpu().numpy()

    ell_vals = dev.ell_vals.detach().cpu().double().numpy()
    er_vals = dev.er_vals.detach().cpu().double().numpy()
    return EHYB(
        n=dev.n, n_pad=dev.n_pad, n_parts=dev.n_parts,
        vec_size=dev.vec_size, ell_width=ell_vals.shape[2],
        ell_vals=ell_vals, ell_cols=host(dev.ell_cols),
        part_widths=None, slice_widths=None,
        er_rows=er_vals.shape[0], er_width=er_vals.shape[1],
        er_vals=er_vals, er_cols=host(dev.er_cols),
        er_row_idx=host(dev.er_row_idx),
        perm=host(dev.perm), inv_perm=host(dev.inv_perm),
        nnz=int((ell_vals != 0).sum() + (er_vals != 0).sum()),
        nnz_in=int((ell_vals != 0).sum()))


def shard_operator(op, mesh, axis: str = "data",
                   csr: Optional[SparseCSR] = None) -> ShardedOperator:
    """Shard a bound EHYB-family :class:`~repro_torch.api.LinearOperator`
    over ``mesh[axis]`` (the implementation behind the registry's
    ``FormatSpec.shard`` hook)."""
    from ..core.sparse_linear import _host_ehyb_of

    e = _host_ehyb_of(op)
    if e is None:
        raise TypeError(
            f"cannot recover the host EHYB build from a {op.format!r} "
            f"operator; pass the SparseCSR to build_sharded_spmv")
    bump("shard_operator")
    return _from_host(e, mesh, axis, op.format, op.dtype,
                      csr=csr if csr is not None else op.csr,
                      pattern_key=op.plan.key, tuning=op.plan.tuning)


def _build_sharded_operator(a, mesh, axis: str = "data",
                            format: str = "auto", dtype=None, *,
                            mode: str = "model",
                            shared: Optional[dict] = None,
                            pattern_key: Optional[str] = None,
                            tuning=None) -> ShardedOperator:
    """Build this rank's :class:`ShardedOperator` over ``mesh[axis]`` (the
    engine behind ``repro_torch.api.plan(A, mesh=...)``).

    ``a`` may be a host :class:`SparseCSR` (planned with ``plan(a,
    mesh=)``: format ranked in the ``"dist"`` context on a multi-rank mesh,
    preconditioned solve, value refills; with ``shared["ehyb"]``, the
    plan's own host build, it is sharded as it is), a bound EHYB-family
    ``LinearOperator``, a host :class:`EHYB` build, or a bare
    :class:`EHYBDevice` (the legacy shim's path: applies only,
    :func:`ehyb_from_device`).  Any
    ``n_parts``/``n_dev`` works: partitions that do not divide the mesh
    axis are padded with empty tiles."""
    from ..api.operator import LinearOperator

    if isinstance(a, ShardedOperator):
        return a
    if isinstance(a, SparseCSR):
        if shared is not None and "ehyb" in shared:
            return _from_host(shared["ehyb"], mesh, axis, format, dtype,
                              csr=a, pattern_key=pattern_key, tuning=tuning)
        from ..api.config import ExecutionConfig
        from ..api.plan import plan

        p = plan(a, mesh=mesh, mesh_axis=axis,
                 execution=ExecutionConfig(format=format, mode=mode))
        return p._engine(p.bind(a, dtype=dtype))
    if isinstance(a, LinearOperator):
        return shard_operator(a, mesh, axis)
    if isinstance(a, EHYB):
        return _from_host(a, mesh, axis, "ehyb", dtype)
    if isinstance(a, EHYBBuckets):
        return _build_sharded_operator(a.base, mesh, axis, format, dtype)
    if isinstance(a, EHYBDevice):
        return _from_host(ehyb_from_device(a), mesh, axis, "ehyb", dtype)
    raise TypeError(f"cannot shard a {type(a).__name__}; pass the "
                    f"SparseCSR, its host EHYB build or a bound EHYB-family "
                    f"operator")


def build_sharded_spmv(a, mesh, axis: str = "data", format: str = "auto",
                       dtype=None, *, mode: str = "model",
                       shared: Optional[dict] = None) -> ShardedOperator:
    """Deprecated: use ``repro_torch.api.plan(a, mesh=mesh).bind(a)`` — the
    same halo-plan engine behind the unified ``LinearOperator`` contract."""
    import warnings

    warnings.warn(
        "repro_torch.dist.build_sharded_spmv is deprecated; use "
        "repro_torch.api.plan(A, mesh=mesh).bind(A)",
        DeprecationWarning, stacklevel=2)
    return _build_sharded_operator(a, mesh, axis, format, dtype, mode=mode,
                                   shared=shared)
