"""Continuous-batching inference engine over heterogeneous-rank adapters
(port of ``repro/serving/engine.py``).

The engine owns ``max_slots`` slots; a slot is one row of every batched
buffer: one row of the KV cache (``init_cache`` layout, batch axis 1, each
slot at its own ragged position), one row of the prompt / vision staging
buffers and one adapter-bank index.  Each :meth:`ServingEngine.step`:

1. **admits** queued requests into free slots (continuous batching; with
   ``continuous=False`` only when every slot is free): the adapter is
   pinned in the :class:`~repro_torch.serving.adapter_store.AdapterStore`
   (paged in when cold), the prompt and the projected vision prefix are
   staged, and the slot's cache rows are zeroed (``serve_admit``).  With
   ``prefill_chunk`` set, the burst of slots admitted together is filled by
   ``max_s ⌈P_s/chunk⌉`` shared ``serve_prefill`` calls;
2. **decodes** one token for every occupied slot in one ``serve_step``:
   each row muxes its input (vision-prefix vector, teacher-forced prompt
   token, or its last generated token), applies its own adapter by bank
   index (``lora_backend="gather"``: per-row gathered (A, B) pairs in plain
   PyTorch; ``"grouped"``: the BGMV kernel) and writes its next token into
   its generation buffer on the device;
3. **retires** finished slots from host-side position mirrors — the only
   device→host transfer is one fetch of the finished rows' tokens and
   fault flags per retire burst.

The reference jits these steps with donated buffers; here they run eagerly
and update the cache and the slot state IN PLACE.  Nothing syncs with the
host per step.

A row whose logits turn non-finite gets a sticky ``fault`` flag and emits
token 0; only that request completes with ``status="error"``.  Cancelling
(:meth:`ServingEngine.cancel` / :meth:`~ServingEngine.cancel_slot`, with
``status="cancelled"`` or ``"timeout"``) is host bookkeeping and launches
nothing.  Cancelled, timed-out and shed requests count under
``serving.cancelled`` / ``serving.timeout`` / ``serving.shed`` and never
reach the latency, TTFT or queue-wait histograms.

The engine itself is policy-free FIFO; ``Request`` carries an SLO class,
a deadline, its submit attempts and whether its length was clamped, which
the scheduler (``repro_torch.serving.scheduler``) uses and the completion
records report.  Time comes from ``self.clock`` (``time.perf_counter``
unless a scheduler injects its own).  Sampling (:class:`SamplingConfig`)
draws Gumbel noise from a counter-based hash of ``(sample_seed, uid,
position, token)`` on the device: a request's tokens are reproducible
wherever and whenever it runs, and ``top_k=1`` is greedy.

On a serving mesh (``mesh=``, a ``repro_torch.launch.mesh.Mesh`` with a
``"data"`` axis) every rank runs the same host loop — admission, paging,
the position mirrors — while the device state splits: each rank of the
``"data"`` axis holds a contiguous block of ``max_slots / data`` slot rows
(their cache, staging buffers and generation buffers) and decodes only
those; on a ``("data", "model")`` mesh the base weights, the cache's K/V
heads (Mamba's state heads and conv channels; MLA's latents stay whole)
and the bank's ``B`` rows and ``A`` columns at the split sites are the
rank's tensor-parallel pieces (``repro_torch.models.tensor_parallel``),
for every family the engine serves; the BGMV kernel runs on the local
slots at the shard shapes, the greedy token is
the argmax over every rank's vocabulary columns and sampling draws from
the gathered logits.  The finished rows' tokens and fault flags are
all-gathered over ``"data"`` at each retire burst, so every rank completes
the same requests with the same tokens.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.paging import AllSlotsPinnedError
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import (make_chunked_prefill_step,
                                      make_multi_adapter_serve_step)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.tensor_parallel import TensorParallel
from repro_torch.serving.adapter_store import (AdapterQuarantinedError,
                                               AdapterStore)
from repro_torch.telemetry import Telemetry, span

Tree = Any
_UIDS = itertools.count()

#: request SLO classes, highest priority first
SLO_CLASSES = ("interactive", "batch")

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer hash (xorshift-multiply).  ``x``: a Python int or an
    int64 tensor holding values in [0, 2³²); every product stays below 2⁶³,
    so the tensor and the int versions agree bit for bit."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Opt-in stochastic decoding: logits scaled by ``1/temperature``,
    optionally truncated to the ``top_k`` largest, sampled per slot.
    Greedy (``sampling=None``) stays the default; ``top_k=1`` is greedy."""

    temperature: float = 1.0
    top_k: int = 0                     # 0 = full vocabulary


@dataclasses.dataclass(eq=False)
class Request:
    """One inference request: decode ``gen_len`` tokens after the
    teacher-forced ``prompt_tokens`` (and, for prefix-VLMs, the ``vision``
    patches), through adapter ``adapter_id``.  Identity equality."""

    adapter_id: Any
    prompt_tokens: np.ndarray          # int [P_t]
    gen_len: int
    vision: np.ndarray | None = None   # f32 [P, Dv]
    uid: int = dataclasses.field(default_factory=lambda: next(_UIDS))
    submitted_at: float = 0.0
    admitted_at: float | None = None
    first_token_at: float | None = None
    slo: str = "batch"                 # "interactive" | "batch"
    deadline_s: float | None = None    # relative SLO; None = class default
    deadline_at: float | None = None   # absolute, stamped by the scheduler
    status: str = "ok"                 # ok | error | shed | timeout | cancelled
    attempts: int = 0                  # submit attempts (retry-with-backoff)
    degraded: bool = False             # gen_len clamped by the shed policy


class ServingEngine:
    """Multi-tenant continuous-batching decode over an :class:`AdapterStore`
    for stacks whose cache rows a slot reset can zero: ``attn`` /
    ``attn_local`` (dense or MLA) and ``mamba`` sublayers, with dense or
    MoE feed-forwards.  Cross-attention and enc-dec stacks are refused, as
    the reference refuses them; a stack with a Mamba layer prefills by
    streaming (``prefill_chunk=None``).

    ``device=None`` means CUDA (raises without one); params are moved there
    and the store must live there too.  ``mesh``: a serving mesh (module
    docstring); ``params`` are whole — or, with ``split``, already this
    rank's tensor-parallel pieces (``init_params(..., tp=)``,
    ``interop.params_from_numpy(..., mesh=)``) — and the store must be on
    the same mesh or on none (the engine then gives it its own)."""

    def __init__(self, cfg: ModelConfig, params: Tree, store: AdapterStore,
                 *, lora_scale: float, max_slots: int = 8,
                 max_prompt: int = 32, max_gen: int = 32,
                 use_vision: bool | None = None, continuous: bool = True,
                 prefill_chunk: int | None = None,
                 prefill_flash: bool | None = None,
                 lora_backend: str = "gather",
                 sampling: SamplingConfig | None = None,
                 sample_seed: int = 0, mesh=None, split: bool = False,
                 telemetry: Telemetry | None = None, device=None):
        bad = {k for k in cfg.pattern if k not in ("attn", "attn_local",
                                                   "mamba")}
        if bad or cfg.family == "encdec":
            raise NotImplementedError(
                f"serving engine supports attn/attn_local/mamba stacks, got "
                f"pattern {cfg.pattern} family {cfg.family}")
        if lora_backend not in ("gather", "grouped"):
            raise ValueError(f"lora_backend {lora_backend!r} not in "
                             "('gather', 'grouped')")
        if sampling is not None and sampling.temperature <= 0:
            raise ValueError("sampling.temperature must be > 0 "
                             "(use sampling=None for greedy)")
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        self._tp = None
        self._rows = range(max_slots)           # this rank's slot rows
        if mesh is None and store.mesh is not None:
            raise ValueError(
                "AdapterStore carries a serving mesh but the engine is "
                "unsharded — pass the same mesh to ServingEngine too")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"a serving mesh is a repro_torch.launch."
                                f"mesh.Mesh, got {type(mesh).__name__}")
            if "data" not in mesh.axis_names:
                raise ValueError(
                    f"serving mesh needs a 'data' axis for the slot "
                    f"dimension, got axes {tuple(mesh.axis_names)}")
            n_data = mesh.shape["data"]
            if max_slots % n_data != 0:
                raise ValueError(
                    f"max_slots={max_slots} does not divide over the "
                    f"mesh's data axis ({n_data} devices)")
            if store.mesh is not None and store.mesh is not mesh:
                raise ValueError(
                    "AdapterStore was built for a different mesh than the "
                    "engine's — pass the same mesh to both")
            if dev.type != mesh.device.type:
                raise ValueError(f"the engine's device {dev} is not the "
                                 f"mesh's ({mesh.device})")
            self.device = dev = mesh.device
            if "model" in mesh.axis_names:
                self._tp = TensorParallel(cfg, mesh)
            store.set_mesh(mesh, self._tp)
            b = max_slots // n_data
            c = mesh.coord("data")
            self._rows = range(c * b, (c + 1) * b)
        if store.device != dev:
            raise ValueError(f"AdapterStore lives on {store.device}, the "
                             f"engine on {dev}")
        self.cfg = cfg
        if self._tp is not None and not split:
            # frozen base weights: tensor-parallel pieces, never split over
            # "data" (the slot axis; param_spec_tp)
            params = self._tp.shard_params(params)
        self.params = params = _to_device(params, dev)
        self.store = store
        self.lora_scale = lora_scale
        self.max_slots = max_slots
        self.max_prompt = max_prompt
        self.max_gen = max_gen
        self.continuous = continuous
        self.lora_backend = lora_backend
        self.sampling = sampling
        self.sample_seed = sample_seed
        if use_vision is None:
            use_vision = cfg.family == "vlm" and cfg.vision_mode == "prefix"
        self._n_prefix = cfg.num_vision_tokens if use_vision else 0
        self.cache_len = self._n_prefix + max_prompt + max_gen
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            if "mamba" in cfg.pattern:
                raise NotImplementedError(
                    "chunked prefill needs positional cache rows; a mamba "
                    "state is recurrent — use streamed prefill "
                    "(prefill_chunk=None) for mamba stacks")
            if "attn_local" in cfg.pattern and cfg.sliding_window:
                ring = min(self.cache_len, cfg.sliding_window)
                if prefill_chunk > ring:
                    raise ValueError(
                        f"prefill_chunk {prefill_chunk} exceeds the local "
                        f"layers' ring cache ({ring} rows) — per-row "
                        "scatter indices would collide")
                max_fill = self._n_prefix + max_prompt - 1
                if prefill_chunk > 1 and max_fill > ring:
                    raise ValueError(
                        f"chunked prefill would wrap the local layers' ring "
                        f"cache: up to {max_fill} teacher-forced positions "
                        f"vs {ring} ring rows (a chunk writes all its K/V "
                        "rows before attending).  Shrink max_prompt, grow "
                        "the window, or use streamed prefill "
                        "(prefill_chunk=None)")
        self.prefill_chunk = prefill_chunk

        B = len(self._rows)                     # the slot rows held here
        self._cache = T.init_cache(cfg, params, B, self.cache_len,
                                   tp=self._tp)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = {"ptoks": zeros(B, max_prompt), "aidx": zeros(B),
                 "pos": zeros(B), "plen": zeros(B),
                 "tlen": zeros(B),             # 0 = slot free/inactive
                 "last": zeros(B), "gen": zeros(B, max_gen),
                 # sticky per-slot fault bit, cleared at (re-)admission
                 "fault": zeros(B, dtype=torch.bool)}
        if self._n_prefix:
            # PROJECTED prefix vectors [P, d_model], computed once at admit
            state["vis"] = zeros(B, cfg.num_vision_tokens, cfg.d_model,
                                 dtype=params["embed"].dtype)
        if sampling is not None:
            state["rng"] = zeros(B)           # per-slot 32-bit sampling key
        self._state = state
        self._step_fn = self._build_step()
        self._prefill_fn = None
        if prefill_chunk is not None:
            self._prefill_fn = make_chunked_prefill_step(
                cfg, lora_scale=lora_scale, chunk=prefill_chunk,
                n_prefix=self._n_prefix, lora_backend=lora_backend,
                flash=prefill_flash, tp=self._tp)

        # host mirrors of every slot (scheduling never fetches device state)
        self._requests: list[Request | None] = [None] * max_slots
        self._pos_h = np.zeros((max_slots,), np.int64)
        self._plen_h = np.zeros((max_slots,), np.int64)
        self._tlen_h = np.zeros((max_slots,), np.int64)
        self.queue: collections.deque[Request] = collections.deque()
        self.completed: list[dict] = []
        self._admit_failed: list[dict] = []
        self.steps = 0
        self.clock = time.perf_counter
        self.prefill_bursts: list[dict] = []
        self.dispatch_count: collections.Counter = store.dispatch_count
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry(enabled=False))
        if telemetry is not None and not store.telemetry.enabled:
            store.use_telemetry(telemetry)   # one registry for both
        m = self.telemetry.metrics
        m.counter_group("serving.dispatch", self.dispatch_count)
        self._h_ttft = m.histogram("serving.ttft_seconds")
        self._h_latency = m.histogram("serving.latency_seconds")
        self._h_queue_wait = m.histogram("serving.queue_wait_seconds")
        self._c_tokens = m.counter("serving.generated_tokens")
        self._c_completed = m.counter("serving.completed_requests")
        # the only places shed, timed-out, cancelled and faulted requests
        # show up: they never touch the histograms above
        self._c_shed = m.counter("serving.shed")
        self._c_timeout = m.counter("serving.timeout")
        self._c_cancelled = m.counter("serving.cancelled")
        self._c_errors = m.counter("serving.request_errors")
        m.gauge_fn("serving.queue_depth", lambda: float(len(self.queue)))
        for cls in SLO_CLASSES:
            # over the engine queue; an SLOScheduler re-registers these over
            # its own pending set (the latest registration wins)
            m.gauge_fn(f"serving.queue_depth.{cls}",
                       lambda c=cls: float(sum(1 for r in self.queue
                                               if r.slo == c)))
        m.gauge_fn("serving.slot_occupancy",
                   lambda: len(self.busy_slots) / self.max_slots)

    # ------------------------------------------------------------ step fns
    def _build_step(self):
        cfg, n_prefix = self.cfg, self._n_prefix
        Sp, max_gen = self.max_prompt, self.max_gen
        sampling = self.sampling
        tp = self._tp
        serve = make_multi_adapter_serve_step(cfg, lora_scale=self.lora_scale,
                                              lora_backend=self.lora_backend,
                                              tp=tp)
        rows = torch.arange(len(self._rows), device=self.device)
        vocab = torch.arange(cfg.vocab_size, device=self.device)

        def serve_step(params, adapters, state, cache):
            pos, plen, tlen = state["pos"], state["plen"], state["tlen"]
            last = state["last"]
            # ---- per-slot input mux: prefix vector | prompt token | last --
            with span("serve_embed"):
                active = pos < tlen
                tok_pos = (pos - n_prefix).clamp(0, Sp - 1)
                prompt_tok = torch.gather(state["ptoks"], 1,
                                          tok_pos[:, None])[:, 0]
                tok = torch.where(pos < plen, prompt_tok, last)
                embeds = (params["embed"][tok] if tp is None    # [B, d]
                          else tp.embed(params["embed"], tok))
                if n_prefix:
                    pre = state["vis"][rows, pos.clamp(0, n_prefix - 1)]
                    embeds = torch.where((pos < n_prefix)[:, None],
                                         pre.to(embeds.dtype), embeds)
            # ---- batched multi-adapter decode (per-row adapter + pos) -----
            logits, _ = serve(params, adapters, state["aidx"], cache, embeds,
                              pos)
            with span("serve_head"):
                # ---- fault containment: non-finite rows flagged, token 0 --
                bad = ~torch.isfinite(logits).all(dim=-1)
                if tp is not None:                  # any rank's vocab columns
                    bad = tp.any(bad)
                fault = state["fault"] | (bad & active)
                if sampling is None:
                    nxt = (torch.argmax(logits, dim=-1) if tp is None
                           else tp.argmax(logits))
                else:
                    if tp is not None:
                        logits = tp.full_logits(logits)
                    lg = logits / sampling.temperature
                    if sampling.top_k:
                        kth = torch.topk(lg, sampling.top_k, dim=-1)[0][:, -1:]
                        lg = torch.where(lg >= kth, lg, -1e30)
                    # Gumbel-max with counter-based noise: key(seed, uid)
                    # mixed with the row's position, then with each token id
                    key = _mix32(state["rng"] ^ _mix32(pos & _M32))
                    h = _mix32((key[:, None] + vocab[None, :] * 0x9E3779B1)
                               & _M32)
                    u = ((h >> 8).float() + 0.5) * 2.0 ** -24
                    nxt = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
                nxt = torch.where(fault, 0, nxt)
                # ---- emit into the slot's generation buffer ---------------
                g = pos - (plen - 1)                # generated-token index
                ok = active & (g >= 0) & (g < max_gen)
                cg = g.clamp(0, max_gen - 1)
                gen = state["gen"]
                gen[rows, cg] = torch.where(ok, nxt, gen[rows, cg])
                state["last"] = torch.where(ok, nxt, last)
                state["fault"] = fault
                pos += active
            return state, cache

        return serve_step

    def _admit(self, slot: int, ptoks: np.ndarray, vision, bank_slot: int,
               plen: int, tlen: int, rng: int) -> None:
        """Stage one admitted request into ``slot`` and zero its cache rows
        (in place; every slot buffer is rewritten) — on the rank that holds
        the slot's row."""
        if slot not in self._rows:
            return
        slot -= self._rows.start
        st, dev = self._state, self.device
        st["ptoks"][slot] = torch.from_numpy(ptoks).to(dev)
        if self._n_prefix:
            # project the prefix ONCE here; the decode step gathers the
            # slot's precomputed [P, d] rows
            dt = st["vis"].dtype
            vis = torch.from_numpy(np.asarray(vision, np.float32)).to(dev)
            st["vis"][slot] = vis.to(dt) @ self.params["vision_proj"].to(dt)
        if self.sampling is not None:
            st["rng"][slot] = rng
        st["aidx"][slot] = bank_slot
        st["fault"][slot] = False
        st["pos"][slot] = 0
        st["plen"][slot] = plen
        st["tlen"][slot] = tlen
        st["last"][slot] = 0
        st["gen"][slot] = 0
        for entry in self._cache.values():
            for c in entry.values():
                c[:, slot].zero_()

    def _sampling_key(self, uid: int) -> int:
        """A request's 32-bit sampling key (a function of seed and uid)."""
        return _mix32((_mix32(self.sample_seed & _M32) + uid) & _M32)

    # ------------------------------------------------------------ scheduling
    @property
    def busy_slots(self) -> list[int]:
        return [s for s in range(self.max_slots)
                if self._requests[s] is not None]

    def validate(self, req: Request) -> None:
        """Reject a bad request up front (raises; never touches the queue)."""
        if not 1 <= len(req.prompt_tokens) <= self.max_prompt:
            raise ValueError(
                f"prompt of {len(req.prompt_tokens)} tokens outside "
                f"[1, max_prompt={self.max_prompt}]")
        if not 1 <= req.gen_len <= self.max_gen:
            raise ValueError(f"gen_len {req.gen_len} outside "
                             f"[1, max_gen={self.max_gen}]")
        if req.slo not in SLO_CLASSES:
            raise ValueError(f"request {req.uid}: slo {req.slo!r} not in "
                             f"{SLO_CLASSES}")
        if req.adapter_id in self.store.quarantined:
            raise AdapterQuarantinedError(
                f"adapter {req.adapter_id!r} is quarantined: "
                f"{self.store.quarantined[req.adapter_id]}")
        if req.adapter_id not in self.store:
            raise KeyError(f"unknown adapter {req.adapter_id!r}")
        if self._n_prefix:
            want = (self.cfg.num_vision_tokens, self.cfg.vision_dim)
            got = None if req.vision is None else np.shape(req.vision)
            if got != want:
                raise ValueError(
                    f"request {req.uid}: vision-prefix engine needs vision "
                    f"patches of shape {want}, got {got}")

    def submit(self, req: Request) -> int:
        self.validate(req)
        req.submitted_at = self.clock()
        req.admitted_at = None
        req.first_token_at = None
        req.status = "ok"
        self.queue.append(req)
        return req.uid

    def _admit_pending(self) -> int:
        busy = self.busy_slots
        if not self.continuous and busy:
            return 0            # static batching: wait for the batch to drain
        admitted = 0
        newly: list[int] = []   # slots admitted this call (one prefill burst)
        free = [s for s in range(self.max_slots) if self._requests[s] is None]
        burst = (self.telemetry.span("admit_burst", cat="serving",
                                     queued=len(self.queue), free=len(free))
                 if self.queue and free else contextlib.nullcontext())
        with burst:
            while self.queue and free:
                req = self.queue[0]
                try:
                    bank_slot = self.store.acquire(req.adapter_id)
                except AdapterQuarantinedError as e:
                    # fail THIS request and keep admitting
                    self.queue.popleft()
                    self._fail_admission(req, str(e))
                    continue
                except AllSlotsPinnedError:
                    break        # adapter bank exhausted by pinned tenants
                self.queue.popleft()
                slot = free.pop(0)
                n_p = len(req.prompt_tokens)
                ptoks = np.zeros((self.max_prompt,), np.int64)
                ptoks[:n_p] = np.asarray(req.prompt_tokens, np.int64)
                plen = self._n_prefix + n_p
                tlen = plen + req.gen_len - 1      # last fed position + 1
                self.dispatch_count["serve_admit"] += 1
                with self.telemetry.span("serve_admit", cat="dispatch",
                                         uid=req.uid, slot=slot, slo=req.slo):
                    self._admit(slot, ptoks, req.vision, bank_slot, plen,
                                tlen, self._sampling_key(req.uid))
                req.admitted_at = self.clock()
                self._requests[slot] = req
                self._pos_h[slot] = 0
                self._plen_h[slot] = plen
                self._tlen_h[slot] = tlen
                newly.append(slot)
                admitted += 1
        if self.prefill_chunk is not None and newly:
            # SHARED chunked prefill: max_s ⌈P_s/chunk⌉ calls fill every
            # slot admitted this step together
            fills = [int(self._plen_h[s]) - 1 for s in newly]
            n_disp = max(-(-f // self.prefill_chunk) for f in fills)
            self.prefill_bursts.append({"fills": fills, "dispatches": n_disp})
            with self.telemetry.span("prefill_burst", cat="serving",
                                     slots=len(newly), dispatches=n_disp):
                for _ in range(n_disp):
                    self.dispatch_count["serve_prefill"] += 1
                    with self.telemetry.span("serve_prefill", cat="dispatch"):
                        self._prefill_fn(self.params, self.store.scan_stack,
                                         self._state, self._cache)
            for s, n_fill in zip(newly, fills):
                self._pos_h[s] = n_fill
        return admitted

    def _fail_admission(self, req: Request, error: str) -> dict:
        """Complete ``req`` with an error status without it ever occupying a
        slot (quarantined adapter discovered at admission)."""
        req.status = "error"
        rec = {"uid": req.uid, "adapter_id": req.adapter_id,
               "slo": req.slo, "status": "error", "error": error,
               "attempts": req.attempts,
               "tokens": np.zeros((0,), np.int32),
               "latency_s": self.clock() - req.submitted_at}
        self._c_errors.inc()
        self._c_completed.inc()
        self.telemetry.instant("request_complete", cat="serving",
                               uid=req.uid, slo=req.slo, status="error")
        self.completed.append(rec)
        self._admit_failed.append(rec)
        return rec

    def _retire_finished(self) -> list[dict]:
        done = [s for s in self.busy_slots if self._pos_h[s] >= self._tlen_h[s]]
        if not done:
            return []
        self.dispatch_count["fetch"] += 1
        with self.telemetry.span("fetch", cat="dispatch", rows=len(done)):
            # fault flags ride the SAME transfer as the tokens
            st = self._state
            rows = torch.cat([st["gen"], st["fault"][:, None].long()], dim=1)
            if self.mesh is not None:           # every rank's slot rows
                rows = self.mesh.all_gather(rows, "data")
            idx = torch.tensor(done, device=self.device)
            fetched = rows[idx].cpu().numpy()
        gen_rows, fault_rows = fetched[:, :-1], fetched[:, -1]
        out = []
        now = self.clock()
        m = self.telemetry.metrics
        for i, s in enumerate(done):
            req = self._requests[s]
            self.store.release(req.adapter_id)
            self._requests[s] = None
            self._plen_h[s] = 0
            self._tlen_h[s] = 0
            status = "error" if bool(fault_rows[i]) else "ok"
            req.status = status
            rec = {"uid": req.uid, "adapter_id": req.adapter_id,
                   "slo": req.slo, "status": status,
                   "attempts": req.attempts,
                   "tokens": gen_rows[i][:req.gen_len].astype(np.int32),
                   "latency_s": now - req.submitted_at,
                   "ttft_s": req.first_token_at - req.submitted_at,
                   "queue_wait_s": req.admitted_at - req.submitted_at}
            if req.deadline_at is not None:
                rec["deadline_s"] = req.deadline_at - req.submitted_at
            if req.degraded:
                rec["degraded"] = True
            if status == "error":
                rec["error"] = "non-finite logits during decode"
            out.append(rec)
            if status == "ok":
                self._h_latency.observe(rec["latency_s"])
                self._h_ttft.observe(rec["ttft_s"])
                self._h_queue_wait.observe(rec["queue_wait_s"])
                m.histogram(f"serving.latency_seconds.{req.slo}").observe(
                    rec["latency_s"])
                m.histogram(f"serving.ttft_seconds.{req.slo}").observe(
                    rec["ttft_s"])
                self._c_tokens.inc(req.gen_len)
            else:
                self._c_errors.inc()
            self._c_completed.inc()
            self.telemetry.instant("request_complete", cat="serving",
                                   uid=req.uid, slo=req.slo, status=status)
        self.completed.extend(out)
        return out

    # ------------------------------------------------------------ cancellation
    def _cancelled(self, req: Request, status: str, **tags) -> dict:
        """Complete ``req`` as ``status`` (``"cancelled"`` or ``"timeout"``)
        with no tokens."""
        req.status = status
        rec = {"uid": req.uid, "adapter_id": req.adapter_id,
               "slo": req.slo, "status": status, "attempts": req.attempts,
               "tokens": np.zeros((0,), np.int32),
               "latency_s": self.clock() - req.submitted_at}
        (self._c_timeout if status == "timeout" else self._c_cancelled).inc()
        self._c_completed.inc()
        self.telemetry.instant("request_cancelled", cat="serving",
                               uid=req.uid, slo=req.slo, status=status,
                               **tags)
        self.completed.append(rec)
        return rec

    def cancel_slot(self, slot: int, *, status: str = "cancelled") -> dict:
        """Cancel the in-flight request in ``slot`` at a step boundary.
        Host bookkeeping only: the device row keeps advancing until
        re-admission rewrites it (rows are independent)."""
        req = self._requests[slot]
        if req is None:
            raise ValueError(f"slot {slot} has no in-flight request")
        self.store.release(req.adapter_id)
        self._requests[slot] = None
        self._pos_h[slot] = 0
        self._plen_h[slot] = 0
        self._tlen_h[slot] = 0
        return self._cancelled(req, status, slot=slot)

    def cancel(self, uid: int, *, status: str = "cancelled") -> dict:
        """Cancel a request by uid — queued or in flight."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                return self._cancelled(r, status)
        for s in self.busy_slots:
            if self._requests[s].uid == uid:
                return self.cancel_slot(s, status=status)
        raise KeyError(f"no queued or in-flight request with uid {uid}")

    # ------------------------------------------------------------ driving
    def step(self) -> list[dict]:
        """Admit → one decode step → retire.  Returns the requests that
        completed this step (admission-time quarantine failures included).
        The telemetry is current for the step, so the layers it launches
        record their spans (``serve_embed``, each layer's ``mamba_mixer`` /
        ``attn_mixer`` and ``moe``, ``bgmv`` inside a mixer, ``serve_head``)
        under ``serve_step``, and a chunked prefill's under
        ``serve_prefill``."""
        with self.telemetry.current():
            return self._step()

    def _step(self) -> list[dict]:
        self._admit_pending()
        failed, self._admit_failed = self._admit_failed, []
        busy = self.busy_slots
        if not busy:
            return failed
        self.dispatch_count["serve_step"] += 1
        self.steps += 1
        with self.telemetry.span("serve_step", cat="dispatch",
                                 slots=len(busy)):
            self._step_fn(self.params, self.store.scan_stack, self._state,
                          self._cache)
        now = self.clock()
        for s in busy:
            self._pos_h[s] += 1
            if self._pos_h[s] == self._plen_h[s]:
                # this step emitted the request's first token
                self._requests[s].first_token_at = now
        return failed + self._retire_finished()

    def run(self, requests=None, max_steps: int | None = None) -> list[dict]:
        """Submit ``requests`` and step until queue and slots drain; returns
        the completion records in completion order."""
        for r in requests or ():
            self.submit(r)
        n0 = len(self.completed)
        steps0 = self.steps
        while self.queue or self.busy_slots:
            self.step()
            if max_steps is not None and self.steps - steps0 >= max_steps:
                raise RuntimeError(f"exceeded max_steps={max_steps} with "
                                   f"{len(self.queue)} queued requests")
        return self.completed[n0:]

    def reset(self) -> None:
        """Return the engine to empty (no queued/busy requests, zeroed slot
        state, fresh counters).  In-flight adapters are unpinned; the
        store's residency is left as it is."""
        for s in self.busy_slots:
            self.store.release(self._requests[s].adapter_id)
            self._requests[s] = None
        self.queue.clear()
        self.completed = []
        self._admit_failed = []
        for t in self._state.values():
            t.zero_()
        self._pos_h[:] = 0
        self._plen_h[:] = 0
        self._tlen_h[:] = 0
        self.steps = 0
        self.prefill_bursts = []
        self.dispatch_count.clear()


def _to_device(tree: Tree, device: torch.device) -> Tree:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


__all__ = ["Request", "SamplingConfig", "ServingEngine", "SLO_CLASSES"]
