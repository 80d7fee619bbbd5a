"""Serving engine: prefill + decode steps with continuous batching.

The port of ``repro.serve.engine``.  The engine keeps a fixed pool of
``batch`` decode slots.  Requests queue up; ALL free slots are prefilled
in one full-width prefill per ``step()`` (admitted rows merged into the
live state under a mask), and every step advances all active slots one
token with their true per-slot positions — slots admitted at different
times each write their KV-cache entry at their own index.  Finished slots
(EOS or max tokens) are returned and immediately refillable — the
vLLM-style decoupling of request lifetime from batch shape, minus paging.

Sampling: greedy or temperature (per-request), computed on the host from
the logits of the single new position, with ``np.random.default_rng(seed)``.

Sparse decode head (``sparse_head_density``): the LM head is the largest
single decode-step matmul (d_model × vocab every token).  When set, the
head weights are magnitude-pruned and served through the operator API
(``repro_torch.api.pruned_linear`` → plan → bind → apply).  Every step runs
all slots through one decode (and one prefill), so the concurrent users'
head matvecs coalesce into one apply of width ``batch``: the head is
planned at that width (``pruned_linear(..., k=batch)``), and on the card an
``ehyb_packed`` head runs the packed fused SpMM kernel at two or more
slots and the packed fused SpMV kernel at one (``kernels.ops``).  The
activations arrive in feature order and the logits leave in vocab order,
so the boundary permutations are paid per step.  ``sparse_head_partition``
pins the head's partition strategy (the port's keyword; the default, None,
prices every strategy as the reference does).

PyTorch runs eagerly, so nothing is compiled: the reference's ``_rejit``
becomes the choice of the head callable, sparse or dense.  The sparse
head's device container still reaches every step as an argument
(``apply_with(head_obj, h)``), so ``refresh_sparse_head`` refills the value
tables through the operator's scatter (same mask, same partitioning, no
build and no packing) and the next step computes with the new values.
Every step runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import Counter, deque
from typing import Callable, Optional

import numpy as np
import torch

from ..core.counters import bump
from ..models import decode_step, init_decode_state, prefill
from ..models.layers import cdtype, logits_fn, softcap
from ..reliability.policy import EnginePolicy, ReliabilityWarning


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: int = -1
    ttl_s: Optional[float] = None      # per-request deadline (None = policy)
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    reject_reason: Optional[str] = None   # "queue_full" | "deadline" | None
    _submit_t: Optional[float] = None
    _deadline: Optional[float] = None


def _merge(old, new, mask: torch.Tensor):
    """The state trees' leaves are (n_units, B, ...): ``new`` where the
    (B,) mask is set, ``old`` elsewhere."""
    if isinstance(old, dict):
        return {k: _merge(old[k], new[k], mask) for k in old}
    m = mask.reshape((1, -1) + (1,) * (new.ndim - 2))
    return torch.where(m, new.to(old.dtype), old)


class ServeEngine:
    def __init__(self, params, cfg, *, batch: int = 4, max_len: int = 256,
                 max_prompt: int = 64, state_dtype=torch.float32,
                 seed: int = 0,
                 sparse_head_density: Optional[float] = None,
                 sparse_head_format: str = "auto",
                 sparse_head_partition: Optional[str] = None,
                 sparse_head_mesh=None, sparse_head_axis: str = "data",
                 max_queue: Optional[int] = None,
                 policy: Optional[EnginePolicy] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device=None):
        from ..api.plan import resolve_device

        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.batch, self.max_len, self.max_prompt = batch, max_len, max_prompt
        self.policy = policy or EnginePolicy()
        if max_queue is not None:
            self.policy = dataclasses.replace(self.policy,
                                              max_queue=max_queue)
        self._clock = clock or time.monotonic
        self.stats: Counter = Counter()
        self.degraded = False
        self.degraded_reason: Optional[str] = None
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * batch
        self.positions = np.zeros(batch, np.int32)
        self.state = init_decode_state(cfg, batch, max_len, state_dtype,
                                       enc_len=max_prompt,
                                       device=self.device)
        self.rng = np.random.default_rng(seed)
        self.sparse_head = self._build_sparse_head(
            sparse_head_density, sparse_head_format, sparse_head_partition,
            sparse_head_mesh, sparse_head_axis)
        # the head the steps run: the sparse layer on the healthy path,
        # None (the dense head) in degraded mode — where the reference
        # re-jits its step programs, eager PyTorch swaps this
        self._head = self.sparse_head

    def _head_weights(self) -> np.ndarray:
        """The dense (V, d) LM-head weights under the current params."""
        if self.cfg.tie_embeddings:
            w = self.params["embed"]["embedding"]               # (V, d)
        else:
            w = self.params["head"]["w_head"].T                 # (d,V) -> (V, d)
        return w.detach().float().cpu().numpy()

    def _build_sparse_head(self, density, fmt, partition=None, mesh=None,
                           axis="data"):
        """Prune the LM head into the sparse layer (or None).

        A ``mesh`` shards the pruned head over ``mesh[axis]`` (halo-exchange
        applies, activations and logits replicated), and the device is the
        mesh's."""
        if density is None:
            return None
        from ..api import pruned_linear

        # plan at the slot-pool width: every step coalesces the active
        # slots' head matvecs into one (d, batch)-wide apply, so the format
        # ranking prices the A-stream amortized over it
        return pruned_linear(self._head_weights(), density=density,
                             format=fmt, partition_method=partition,
                             mesh=mesh, mesh_axis=axis, k=self.batch,
                             device=None if mesh is not None
                             else self.device)

    def _head_obj(self):
        """The sparse head's device container, passed to the steps as an
        argument, so a refresh reaches the next step.  Degraded mode serves
        the dense head — no container to pass."""
        if self.sparse_head is None or self.degraded:
            return None
        return self.sparse_head.op.obj

    def refresh_sparse_head(self, params=None):
        """Value-refresh the served pruned head after a weight update.

        The pruning mask and the format's partitioning survive:
        ``SparseLinear.update_values`` refills the device value tables
        through the operator's scatter, and the refreshed container reaches
        the next ``step()`` as an argument.  No partitioning, no build, no
        packing per weight push."""
        if params is not None:
            self.params = params
        if self.sparse_head is None:
            return None
        self.sparse_head = self.sparse_head.update_values(self._head_weights())
        return self.sparse_head

    def sparse_head_bytes(self, val_bytes: int = 4):
        """Modeled bytes of one step's head apply (None if the dense head
        is in use)."""
        if self.sparse_head is None:
            return None
        return self.sparse_head.bytes_vs_dense(val_bytes)

    # ---- step functions ----------------------------------------------------

    def _head_logits(self, h: torch.Tensor, head, head_obj=None):
        """Logits of the hidden states ``h`` (B, 1, d): the dense head
        (``head`` None) in the compute dtype, or the sparse layer's apply of
        container ``head_obj``, which computes on h promoted to the
        layer's dtype and returns that dtype."""
        if head is None:
            return logits_fn(self.params["head"], self.params["embed"], h,
                             self.cfg)
        return softcap(head.apply_with(head_obj, h), self.cfg.final_softcap)

    def _decode_impl(self, tokens, state, pos_vec, head_obj, head):
        # true per-slot positions: each slot writes its KV-cache entry (and
        # takes its RoPE angle / causal horizon) at its own index
        h, new_state = decode_step(self.params, tokens, self.cfg, state,
                                   pos_vec)
        logits = self._head_logits(h, head, head_obj)
        return logits[:, 0], new_state

    def _prefill_impl(self, batchd, state, admit_mask, head_obj, head):
        """Full-width prefill: every waiting request's row runs through one
        prefill per step and ``admit_mask`` (B,) merges only the admitted
        rows' state back — active slots keep theirs.  All admitted prompts'
        last-position head matvecs coalesce into the one batched head
        apply."""
        h_last, st = prefill(self.params, batchd, self.cfg, state)
        logits = self._head_logits(h_last, head, head_obj)
        return logits[:, 0], _merge(state, st, admit_mask)

    # ---- request management ------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admission control: returns True if queued, False if rejected.

        A rejected request comes back ``done=True`` with
        ``reject_reason="queue_full"``.  Deadlines are stamped here
        (``req.ttl_s`` falling back to the policy's ``default_ttl_s``) and
        enforced at every step."""
        now = self._clock()
        req._submit_t = now
        ttl = req.ttl_s if req.ttl_s is not None else self.policy.default_ttl_s
        req._deadline = None if ttl is None else now + ttl
        mq = self.policy.max_queue
        if mq is not None and len(self.queue) >= mq:
            req.done = True
            req.reject_reason = "queue_full"
            self.stats["rejected_queue_full"] += 1
            bump("serve.rejected_queue_full")
            return False
        self.queue.append(req)
        self.stats["submitted"] += 1
        return True

    def _expire(self) -> list:
        """Drop queued and active requests whose deadline has passed
        (``reject_reason="deadline"``; an active slot frees immediately —
        its partial ``generated`` tokens stay on the request)."""
        now = self._clock()
        finished = []
        if any(r._deadline is not None and now >= r._deadline
               for r in self.queue):
            keep: deque[Request] = deque()
            while self.queue:
                r = self.queue.popleft()
                if r._deadline is not None and now >= r._deadline:
                    r.done = True
                    r.reject_reason = "deadline"
                    self.stats["expired_queued"] += 1
                    bump("serve.expired")
                    finished.append(r)
                else:
                    keep.append(r)
            self.queue = keep
        for i, r in enumerate(self.slots):
            if (r is not None and r._deadline is not None
                    and now >= r._deadline):
                r.done = True
                r.reject_reason = "deadline"
                self.stats["expired_active"] += 1
                bump("serve.expired")
                finished.append(r)
                self.slots[i] = None
                self.positions[i] = 0
        return finished

    # ---- failure handling --------------------------------------------------
    def _enter_degraded(self, reason: str) -> None:
        """Swap the sparse pruned head for the dense path and stop passing
        the sparse container.  The sparse layer is kept —
        ``restore_sparse_head()`` swaps back once the fault clears."""
        self.degraded = True
        self.degraded_reason = reason
        self._head = None
        self.stats["degraded"] += 1
        bump("serve.degraded")
        warnings.warn(
            f"ServeEngine degraded to the dense head after repeated "
            f"sparse-apply failures ({reason})", ReliabilityWarning,
            stacklevel=3)

    def restore_sparse_head(self) -> None:
        """Leave degraded mode (no-op when healthy)."""
        if not self.degraded:
            return
        self.degraded = False
        self.degraded_reason = None
        self._head = self.sparse_head

    def _guarded_call(self, which: str, *args):
        """Run a step with retry/backoff and degraded-mode escalation.
        ``args`` end with ``head_obj`` by construction of both call sites;
        non-finite logits count as a failure (a silently corrupted step
        poisons every subsequent token).  Returns (host logits, state).

        A CPU engine retries and degrades on any step failure, as the
        reference does.  On the card only an injected fault does: a
        :class:`ChaosFault`, or non-finite logits while chaos injects NaN.
        An organic failure (a kernel that does not build or launch, a CUDA
        fault, non-finite logits) is raised, as the guarded apply raises
        it, so a failing kernel is never served by the dense head."""
        from ..reliability.chaos import ChaosFault
        from ..reliability.chaos import active as _chaos_active

        pol = self.policy
        on_card = self.device.type == "cuda"
        last: Optional[BaseException] = None
        for phase in range(2):
            fn = self._decode_impl if which == "decode" else \
                self._prefill_impl
            for attempt in range(pol.max_retries + 1):
                c = _chaos_active()
                nan0 = c.injected["nan"] if c is not None else 0
                try:
                    if c is not None:
                        c.check_serve(sparse_active=args[-1] is not None)
                    with torch.no_grad():
                        logits, state = fn(*args, self._head)
                    logits = logits.float().cpu().numpy()
                    if not np.isfinite(logits).all():
                        raise FloatingPointError(
                            f"{which} step produced non-finite logits")
                    return logits, state
                except Exception as e:   # noqa: BLE001 — see the docstring
                    injected = isinstance(e, ChaosFault) or (
                        isinstance(e, FloatingPointError) and c is not None
                        and c.injected["nan"] > nan0)
                    if on_card and not injected:
                        raise
                    last = e
                    self.stats["retries"] += 1
                    bump("serve.retry")
                    if attempt < pol.max_retries and pol.retry_backoff_s > 0:
                        time.sleep(pol.retry_backoff_s * (2 ** attempt))
            if (phase == 0 and self.sparse_head is not None
                    and not self.degraded):
                self._enter_degraded(f"{type(last).__name__}: {last}")
                args = args[:-1] + (None,)
                continue
            break
        raise last

    def health(self) -> dict:
        """Liveness/degradation snapshot (host state, no device sync).
        Includes the plan/tune cache picture (``plan_cache``): with a
        persistent tune store active, its disk hit/miss counters show
        whether the pruned head's plan warm-started from disk."""
        from ..api import PLAN_CACHE

        return {
            "queue_depth": len(self.queue),
            "active": sum(r is not None for r in self.slots),
            "batch": self.batch,
            "degraded": self.degraded,
            "degraded_reason": self.degraded_reason,
            "sparse_head": self.sparse_head is not None,
            "max_queue": self.policy.max_queue,
            "stats": dict(self.stats),
            "plan_cache": PLAN_CACHE.stats(),
        }

    def _free_slots(self):
        return [i for i, r in enumerate(self.slots) if r is None]

    def _admit(self):
        """Admit waiting requests into ALL free slots with one coalesced
        full-width prefill (their head matvecs run as one batched apply).

        The token sampled from the prefill logits is the request's FIRST
        generated token, so it counts against ``max_new_tokens`` and is
        checked against EOS right here.  Prompts are right-padded with
        zeros to ``max_prompt``, and the prefill's hidden state is the one
        at the last padded position, as the reference's is.  Returns the
        list of requests finished at admission."""
        finished = []
        free = self._free_slots()
        while free and self.queue:
            admitted = []
            while free and self.queue:
                admitted.append((free.pop(0), self.queue.popleft()))
            toks = np.zeros((self.batch, self.max_prompt), np.int32)
            mask = np.zeros(self.batch, bool)
            for i, req in admitted:
                prompt = req.prompt[-self.max_prompt:]
                toks[i, :len(prompt)] = prompt
                mask[i] = True
            batchd = {"tokens": torch.as_tensor(toks, device=self.device)}
            if self.cfg.family == "encdec":
                batchd["enc_frames"] = torch.zeros(
                    (self.batch, self.max_prompt, self.cfg.d_model),
                    dtype=cdtype(self.cfg), device=self.device)
            logits, self.state = self._guarded_call(
                "prefill", batchd, self.state,
                torch.as_tensor(mask, device=self.device), self._head_obj())
            for i, req in admitted:
                self.slots[i] = req
                self.positions[i] = len(req.prompt[-self.max_prompt:])
                tok = self._sample(logits[i], req)
                req.generated.append(int(tok))
                if (tok == req.eos_id
                        or len(req.generated) >= req.max_new_tokens):
                    req.done = True
                    self.stats["completed"] += 1
                    finished.append(req)
                    self.slots[i] = None
                    self.positions[i] = 0
                    free.append(i)      # reusable within this same pass
        return finished

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / req.temperature)
        p = p / p.sum()
        return int(self.rng.choice(len(p), p=p))

    # ---- main loop ---------------------------------------------------------
    def step(self):
        """Expire what's past deadline, admit what fits, then advance every
        active slot one token."""
        finished = self._expire()
        finished.extend(self._admit())
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return finished
        tokens = np.zeros((self.batch, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].generated[-1]
        logits, self.state = self._guarded_call(
            "decode", torch.as_tensor(tokens, device=self.device),
            self.state, torch.as_tensor(self.positions, device=self.device),
            self._head_obj())
        for i in active:
            req = self.slots[i]
            self.positions[i] += 1
            tok = self._sample(logits[i], req)
            req.generated.append(tok)
            if (tok == req.eos_id or len(req.generated) >= req.max_new_tokens
                    or self.positions[i] >= self.max_len - 1):
                req.done = True
                self.stats["completed"] += 1
                finished.append(req)
                self.slots[i] = None
                self.positions[i] = 0
        return finished

    def run_until_done(self, max_steps: int = 10000):
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and all(s is None for s in self.slots):
                break
        return out
