"""SLO-aware admission over :class:`~repro_torch.serving.engine.ServingEngine`
(port of ``repro/serving/scheduler.py``, host logic and numpy): deadline
scheduling, backpressure + shedding, timeouts with in-flight cancellation,
and client-side retry-with-backoff.

The engine stays a policy-free FIFO executor; this module is the policy
layer a production front-end would run.  Each scheduler ``step()``:

1. **resubmit** — requests shed earlier whose retry backoff has elapsed
   re-enter admission (the SAME ``Request`` object, so the uid — and with
   it the request's sampling key, a function of ``(sample_seed, uid)`` — is
   preserved: a retried stochastic request reproduces its tokens exactly).
2. **expire** — pending requests past their absolute deadline complete as
   ``status="timeout"`` without ever occupying a slot; with
   ``cancel_timeouts`` set, in-flight requests past deadline are cancelled
   at the step boundary via :meth:`ServingEngine.cancel_slot` — pure host
   bookkeeping, ZERO extra launches (the shared decode step never splits;
   the freed slot takes the next admission).
3. **order** — the pending set is sorted by ``(class priority, deadline)``:
   strict priority across SLO classes (``interactive`` ahead of
   ``batch``), earliest-deadline-first within a class.  The sort is
   stable, so equal deadlines keep submission order — an overload burst
   admits exactly the FIFO prefix that fits.
4. **drive** — the ordered prefix is handed to the engine queue for one
   continuous-batching step; whatever the engine could not admit (no free
   slot / adapter bank exhausted) is reclaimed as pending for the next
   step, keeping EDF order decisions fresh rather than frozen at submit
   time.

**Backpressure + shedding.**  Admission room is
``queue_limit + free_slots - pending``: a full pending set sheds new
arrivals under the configured policy — ``"reject"`` (shed the newcomer),
``"drop_lowest"`` (evict the lowest-class, latest-deadline pending victim
if the newcomer outranks it), or ``"degrade"`` (admit with ``gen_len``
clamped to ``degrade_gen_len``; greedy decode is prefix-stable, so a
degraded response is a bit-identical PREFIX of the full one).  Shed
requests never occupy a slot, increment ``serving.shed``, and are
excluded from every latency histogram.  With a :class:`RetryPolicy`, a
shed request is re-queued after an exponential backoff instead of
terminally rejected (each shed attempt still counts).

Time comes from an injectable clock (default ``time.perf_counter``;
:class:`ManualClock` for tests), shared with the engine, so deadline and
backoff behaviour is deterministic under test without wall-clock races.
"""

from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np

from repro_torch.serving.adapter_store import AdapterQuarantinedError
from repro_torch.serving.engine import SLO_CLASSES, Request, ServingEngine

SHED_POLICIES = ("reject", "drop_lowest", "degrade")


class ManualClock:
    """Injectable virtual clock: ``clock()`` reads, ``advance()`` moves.
    Drives deadline/backoff logic deterministically in tests."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry-with-backoff for shed requests: attempt ``k``
    (1-based) is re-queued ``backoff_s * multiplier**(k-1)`` after the
    shed.  ``max_attempts`` bounds TOTAL submissions."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0

    def backoff(self, attempts: int) -> float:
        return self.backoff_s * self.multiplier ** max(attempts - 1, 0)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Per-class default deadlines, backpressure bound, and shed policy.
    ``queue_limit`` bounds the PENDING set (the engine's free slots add
    headroom: an idle engine always admits up to slot capacity even with
    ``queue_limit=0``)."""

    interactive_deadline_s: float = 0.5
    batch_deadline_s: float = 30.0
    queue_limit: int = 64
    shed_policy: str = "reject"
    degrade_gen_len: int = 2
    cancel_timeouts: bool = True
    retry: RetryPolicy | None = None

    def deadline_for(self, req: Request) -> float:
        if req.deadline_s is not None:
            return req.deadline_s
        return (self.interactive_deadline_s if req.slo == "interactive"
                else self.batch_deadline_s)


def _rank(req: Request) -> int:
    return SLO_CLASSES.index(req.slo)


class SLOScheduler:
    """Deadline-aware admission policy driving a :class:`ServingEngine`.

    Terminal request outcomes accumulate in :attr:`results` (engine
    completion records plus shed/timeout records); :meth:`slo_report`
    summarises them into goodput-under-SLO per class.
    """

    def __init__(self, engine: ServingEngine, cfg: SchedulerConfig | None
                 = None, *, clock=None):
        cfg = cfg if cfg is not None else SchedulerConfig()
        if cfg.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy {cfg.shed_policy!r} not in "
                             f"{SHED_POLICIES}")
        if cfg.queue_limit < 0:
            raise ValueError(f"queue_limit must be >= 0, got "
                             f"{cfg.queue_limit}")
        if not 1 <= cfg.degrade_gen_len:
            raise ValueError("degrade_gen_len must be >= 1")
        self.engine = engine
        self.cfg = cfg
        self.clock = clock if clock is not None else engine.clock
        engine.clock = self.clock        # one time source for both layers
        self._pending: list[Request] = []
        self._retry: list[tuple[float, int, Request]] = []  # (ready_at, uid)
        self.results: list[dict] = []
        # per-class depth now means the SCHEDULER's pending set (the engine
        # queue is transient scratch during step()); latest-wins gauge_fn
        # re-registration makes this the live view
        m = engine.telemetry.metrics
        for cls in SLO_CLASSES:
            m.gauge_fn(f"serving.queue_depth.{cls}",
                       lambda c=cls: float(sum(1 for r in self._pending
                                               if r.slo == c)))

    # --------------------------------------------------------------- intake
    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def waiting_retries(self) -> int:
        return len(self._retry)

    def submit(self, req: Request):
        """Validate, stamp deadline, and apply backpressure.  Returns the
        uid when the request entered the pending set, or the terminal
        record when it was shed outright (``None`` while it waits out a
        retry backoff)."""
        now = self.clock()
        req.attempts += 1
        try:
            self.engine.validate(req)
        except AdapterQuarantinedError as e:
            # quarantined tenant: fail THIS request cleanly, don't raise —
            # under load the front-end treats it like any terminal outcome
            req.submitted_at = now
            return self._finish(req, "error", error=str(e))
        req.submitted_at = now
        req.admitted_at = None
        req.first_token_at = None
        req.status = "ok"
        req.deadline_at = now + self.cfg.deadline_for(req)
        room = (self.cfg.queue_limit + self._free_slots()
                - len(self._pending))
        if room <= 0:
            return self._overloaded(req, now)
        self._pending.append(req)
        return req.uid

    def _free_slots(self) -> int:
        return self.engine.max_slots - len(self.engine.busy_slots)

    def _overloaded(self, req: Request, now: float):
        pol = self.cfg.shed_policy
        if pol == "degrade":
            # admit anyway, but clamp the response length — greedy decode
            # is prefix-stable, so the degraded tokens are a bit-identical
            # prefix of the unloaded response (tested)
            if req.gen_len > self.cfg.degrade_gen_len:
                req.gen_len = self.cfg.degrade_gen_len
                req.degraded = True
            self._pending.append(req)
            return req.uid
        if pol == "drop_lowest":
            victim = self._lowest_pending()
            if victim is not None and (
                    (_rank(req), req.deadline_at)
                    < (_rank(victim), victim.deadline_at)):
                self._pending.remove(victim)
                self._shed(victim, now)
                self._pending.append(req)
                return req.uid
        return self._shed(req, now)

    def _lowest_pending(self) -> Request | None:
        if not self._pending:
            return None
        return max(self._pending,
                   key=lambda r: (_rank(r), r.deadline_at))

    def _shed(self, req: Request, now: float):
        """One shed event: count it, then either schedule a retry or
        complete the request as ``status="shed"``."""
        self.engine._c_shed.inc()
        retry = self.cfg.retry
        if retry is not None and req.attempts < retry.max_attempts:
            ready = now + retry.backoff(req.attempts)
            req.status = "shed"
            heapq.heappush(self._retry, (ready, req.uid, req))
            self.engine.telemetry.instant(
                "request_shed", cat="serving", uid=req.uid, slo=req.slo,
                retry_at=ready, attempts=req.attempts)
            return None
        return self._finish(req, "shed")

    def _finish(self, req: Request, status: str, **extra) -> dict:
        """Terminal non-engine outcome (shed/timeout before admission,
        quarantine at submit): record it WITHOUT touching any latency
        histogram."""
        req.status = status
        rec = {"uid": req.uid, "adapter_id": req.adapter_id,
               "slo": req.slo, "status": status, "attempts": req.attempts,
               "tokens": np.zeros((0,), np.int32), **extra}
        if status == "timeout":
            self.engine._c_timeout.inc()
        elif status == "error":
            self.engine._c_errors.inc()
        self.results.append(rec)
        self.engine.telemetry.instant("request_dropped", cat="serving",
                                      uid=req.uid, slo=req.slo,
                                      status=status)
        return rec

    # -------------------------------------------------------------- driving
    def _ready_retries(self, now: float) -> None:
        while self._retry and self._retry[0][0] <= now:
            _, _, req = heapq.heappop(self._retry)
            self.submit(req)     # full backpressure re-applied

    def _expire_pending(self, now: float) -> None:
        expired = [r for r in self._pending
                   if r.deadline_at is not None and now > r.deadline_at]
        for r in expired:
            self._pending.remove(r)
            self._finish(r, "timeout")

    def _cancel_inflight(self, now: float) -> None:
        if not self.cfg.cancel_timeouts:
            return
        eng = self.engine
        for s in list(eng.busy_slots):
            req = eng._requests[s]
            if req.deadline_at is not None and now > req.deadline_at:
                self.results.append(eng.cancel_slot(s, status="timeout"))

    def step(self) -> list[dict]:
        """One scheduling round: retries → expiry/cancellation → EDF order
        → one engine step.  Returns this round's engine completions."""
        now = self.clock()
        self._ready_retries(now)
        self._expire_pending(now)
        self._cancel_inflight(now)
        # strict class priority, EDF within class; stable → FIFO ties
        self._pending.sort(key=lambda r: (_rank(r), r.deadline_at))
        eq = self.engine.queue
        eq.clear()
        eq.extend(self._pending)
        self._pending.clear()
        done = self.engine.step()
        # reclaim what the engine could not admit this step — next round
        # re-sorts, so EDF decisions track deadlines, not submission time
        self._pending.extend(eq)
        eq.clear()
        self.results.extend(done)
        return done

    def run(self, requests=None, max_steps: int | None = None) -> list[dict]:
        """Submit ``requests`` and step until nothing is pending, queued,
        in flight, or waiting out a retry backoff.  With a
        :class:`ManualClock` the idle gaps before retry deadlines are
        skipped by advancing the clock; with a real clock they are slept.
        """
        for r in requests or ():
            self.submit(r)
        n0 = len(self.results)
        steps0 = self.engine.steps
        while (self._pending or self._retry or self.engine.queue
               or self.engine.busy_slots):
            if (self._retry and not self._pending
                    and not self.engine.busy_slots
                    and not self.engine.queue):
                gap = self._retry[0][0] - self.clock()
                if gap > 0:
                    adv = getattr(self.clock, "advance", None)
                    if adv is not None:
                        adv(gap)
                    else:
                        time.sleep(min(gap, 0.05))
            self.step()
            if (max_steps is not None
                    and self.engine.steps - steps0 >= max_steps):
                raise RuntimeError(
                    f"exceeded max_steps={max_steps} with "
                    f"{len(self._pending)} pending requests")
        return self.results[n0:]

    # ------------------------------------------------------------- reporting
    def slo_report(self) -> dict:
        """Goodput-under-SLO per class from the terminal records: an OK
        completion whose latency fits its deadline is goodput; sheds,
        timeouts, errors and deadline-missed completions are not."""
        per = {c: {"offered": 0, "completed_ok": 0, "goodput": 0,
                   "shed": 0, "timeout": 0, "error": 0, "cancelled": 0}
               for c in SLO_CLASSES}
        for rec in self.results:
            d = per.get(rec.get("slo", "batch"))
            if d is None:
                continue
            d["offered"] += 1
            status = rec.get("status", "ok")
            if status == "ok":
                d["completed_ok"] += 1
                dl = rec.get("deadline_s")
                if dl is None or rec["latency_s"] <= dl:
                    d["goodput"] += 1
            elif status in ("shed", "timeout", "error", "cancelled"):
                d[status] += 1
        total = sum(d["offered"] for d in per.values())
        good = sum(d["goodput"] for d in per.values())
        for d in per.values():
            d["goodput_frac"] = (d["goodput"] / d["offered"]
                                 if d["offered"] else float("nan"))
        return {"per_class": per, "offered": total, "goodput": good,
                "goodput_frac": good / total if total else float("nan")}


__all__ = ["ManualClock", "RetryPolicy", "SchedulerConfig", "SHED_POLICIES",
           "SLOScheduler"]
