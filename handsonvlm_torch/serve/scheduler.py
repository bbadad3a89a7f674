"""Continuous-batching scheduler: request threads in, one engine thread.

Port of `handsonvlm_tpu/serve/scheduler.py` (`ContinuousScheduler`). The
engine (serve/continuous.py) owns one persistent device cache, and its
`join`/`step`/`compact` must run from one thread in program order, so
request threads only enqueue a ticket and wait on its event; the loop
thread admits pending tickets at chunk boundaries and steps the shared
batch. A joining request prefills alone or in a fused group and decodes
beside whatever else is live, so short and long generations overlap and a
finished request frees its slot mid-flight.

- `submit(on_tokens=...)` streams each request's new token ids at every
  chunk boundary.
- Admission groups consecutive tickets of one image shape into one
  `join_many`, rounded down to a power of two and capped by
  `max_join_group`; `admit_hold_s` holds an idle engine's admission for
  stragglers so a burst forms full-width joins; a full cursor is compacted
  before a ticket is refused, and exhausted mid-flight before rows are
  truncated (`drain`).
- A TTFT SLO sheds load: `submit` raises `SLORejected` when
  `estimate_ttft()` exceeds it, the estimate counting the admission hold of
  an idle engine.
- Spans (utils/profiling.py, kept while the tracer is on): `sched.queue`
  for each ticket from its enqueue to the start of its group's join (rid:
  the ticket's id, which the engine's spans of the request carry too), and
  `sched.admit` around each admission pass. `ttfts` keeps the latest
  `TTFT_KEPT` latencies.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from handsonvlm_torch.infer.sampler import EOS_TOKEN_ID, SampleOutput
from handsonvlm_torch.serve.continuous import ContinuousEngine
from handsonvlm_torch.utils import profiling

TTFT_KEPT = 4096  # latest first-token latencies a scheduler keeps
_RIDS = itertools.count()


class SLORejected(RuntimeError):
    """Raised by submit() when the estimated TTFT exceeds the caller's SLO:
    a request that cannot meet its deadline fails at once, so the client
    can retry elsewhere, instead of holding a queue place."""


@dataclasses.dataclass
class _Ticket:
    ids: np.ndarray
    images: object  # numpy or a device tensor, passed through untouched
    seed: int
    max_new: int
    temperature: Optional[float]
    top_p: Optional[float]
    frame_map: Optional[np.ndarray]
    on_tokens: Optional[Callable[[List[int]], None]]
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    output: Optional[SampleOutput] = None
    error: Optional[str] = None
    sent: int = 0  # tokens already streamed through on_tokens
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    rid: int = dataclasses.field(default_factory=lambda: next(_RIDS))
    t_queued_ns: int = 0  # perf_counter_ns() at the enqueue


class ContinuousScheduler:
    """Thread-safe front door of the continuous-batching engine.

    `submit()` blocks the calling thread until its request completes and
    returns the request's SampleOutput, as the request would have run alone
    (the engine's per-row positions and draws)."""

    def __init__(self, model, cfg, *, slots: int = 4, max_len: int = 4096, chunk: int = 8,
                 temperature: float = 0.5, top_p: float = 0.9, attn_impl: str = "auto",
                 kv_quant: Optional[str] = None, eos_token_id: int = EOS_TOKEN_ID,
                 max_join_group: int = 8, ttft_slo: Optional[float] = None,
                 admit_hold_s: float = 0.0):
        self.engine = ContinuousEngine(
            model, cfg, slots=slots, max_len=max_len, chunk=chunk, temperature=temperature,
            top_p=top_p, attn_impl=attn_impl, kv_quant=kv_quant, eos_token_id=eos_token_id)
        # TTFT SLO (seconds): None queues without limit
        self.ttft_slo = ttft_slo
        self.slo_rejections = 0
        # EWMAs of the measured step / join times feed the estimator; None
        # until measured, and a cold scheduler never rejects. The first join
        # of each (width, bucket) and the first step are left out: they
        # carry one-time costs (kernel build, allocator growth) that would
        # poison the estimate
        self._step_s: Optional[float] = None
        self._join_s: Optional[float] = None
        self._seen_joins: set = set()
        self._step_warm = False
        self._consec_rejections = 0
        # decode chunks of tickets popped for an in-flight join: they are in
        # neither _pending nor _live while the join runs
        self._in_flight_steps: List[int] = []
        # widest fused join (its transient prefill cache grows with n)
        self.max_join_group = max_join_group
        # idle-engine burst coalescing: wait up to this long for stragglers
        # so a burst forms one full-width join (0: latency first)
        self.admit_hold_s = admit_hold_s
        self._pending: collections.deque = collections.deque()
        self._live: dict = {}  # row -> ticket
        # submit -> first-token latencies (s), the latest TTFT_KEPT
        self.ttfts: collections.deque = collections.deque(maxlen=TTFT_KEPT)
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def alive(self) -> bool:
        """The loop thread runs and the scheduler takes requests."""
        return self._thread.is_alive() and not self._stopped

    # -- request side --------------------------------------------------------

    def submit(self, input_ids, images, *, seed: int, max_new: int,
               temperature: Optional[float] = None, top_p: Optional[float] = None,
               frame_map=None, on_tokens: Optional[Callable[[List[int]], None]] = None,
               timeout: Optional[float] = None,
               ttft_slo: Optional[float] = None) -> SampleOutput:
        t = _Ticket(np.asarray(input_ids), images, seed, max_new, temperature, top_p,
                    frame_map, on_tokens)
        slo = self.ttft_slo if ttft_slo is None else ttft_slo
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler stopped")
            if slo is not None:
                est = self.estimate_ttft()
                if est is not None and est > slo:
                    # probe admission: after many rejections in a row the
                    # estimate may be stale (no joins happen while all are
                    # rejected); let one through to refresh the measurements
                    if self._consec_rejections >= 8:
                        self._consec_rejections = 0
                    else:
                        self.slo_rejections += 1
                        self._consec_rejections += 1
                        raise SLORejected(
                            f"estimated TTFT {est:.2f}s exceeds SLO {slo:.2f}s "
                            f"({len(self._pending)} queued, {len(self._live)} decoding)")
            self._consec_rejections = 0
            t.t_queued_ns = time.perf_counter_ns()
            self._pending.append(t)
            self._cv.notify()
        if not t.event.wait(timeout):
            raise TimeoutError("continuous generate timed out")
        if t.error is not None:
            raise RuntimeError(t.error)
        return t.output

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=30)

    # -- TTFT SLO estimator ---------------------------------------------------

    @staticmethod
    def _estimate_steps(free_slots: int, live_remaining: List[int],
                        queued_steps: List[int]) -> Optional[int]:
        """Decode chunks until a slot frees for a request arriving at the
        back of the queue: free slots serve the queue first, live rows free
        after their remaining chunks, each queued request then holds its
        slot for its whole decode. An upper bound: EOS frees slots sooner."""
        frees = [0] * free_slots + sorted(live_remaining)
        if not frees:
            return None
        heapq.heapify(frees)
        for qs in queued_steps:
            heapq.heappush(frees, heapq.heappop(frees) + qs)
        return frees[0]

    def estimate_ttft(self) -> Optional[float]:
        """Predicted submit -> first-token latency of a request submitted
        now (seconds), or None while the scheduler is cold. Called under
        self._cv; engine state is only changed by the loop thread and the
        estimate tolerates a read in the middle of a step. An idle engine
        holds admission for `admit_hold_s` first, which is added."""
        if self._step_s is None or self._join_s is None:
            return None
        eng = self.engine
        free = sum(1 for s in eng.slots if not s.busy)
        live = [max(1, -(-(s.max_new - len(s.tokens)) // eng.chunk))
                for s in eng.slots if s.busy]
        live = live + list(self._in_flight_steps)
        free = max(0, free - len(self._in_flight_steps))
        queued = [max(1, -(-p.max_new // eng.chunk)) for p in self._pending]
        steps = self._estimate_steps(free, live, queued)
        if steps is None:
            return None
        # joins ahead of ours run on the loop thread too
        n_joins = 1 + -(-len(queued) // max(1, self.max_join_group))
        hold = self.admit_hold_s if eng.idle() and not self._in_flight_steps else 0.0
        return hold + steps * self._step_s + n_joins * self._join_s

    def _ewma(self, attr: str, dt: float, alpha: float = 0.3):
        prev = getattr(self, attr)
        if prev is not None and dt > 10 * prev:
            dt = 10 * prev  # clamp an outlier, so a lasting slowdown still counts
        setattr(self, attr, dt if prev is None else (1 - alpha) * prev + alpha * dt)

    # -- loop side (one thread owns the engine) ---------------------------

    def _fail_all(self, msg: str) -> None:
        with self._cv:
            self._stopped = True
            for t in list(self._pending) + list(self._live.values()):
                t.error = msg
                t.event.set()
            self._pending.clear()
            self._live.clear()

    def _loop(self):
        # inference mode is per thread: the loop thread enters its own
        with torch.inference_mode():
            while True:
                with self._cv:
                    while not self._stopped and not self._pending and not self._live:
                        self._cv.wait()
                    if self._stopped:
                        break
                try:
                    with profiling.span("sched.admit"):
                        self._admit()
                    if self._live:
                        self._step_once()
                except Exception as e:  # noqa: BLE001 - fail the waiters, not strand them
                    self._fail_all(f"scheduler loop error: {type(e).__name__}: {e}")
                    raise
        self._fail_all("scheduler stopped")

    @staticmethod
    def _shape_key(t: _Ticket):
        """Tickets that can share one fused join agree on the shapes the
        group prefill stacks (prompt lengths may differ: the engine
        left-pads)."""
        fm = None if t.frame_map is None else np.shape(t.frame_map)
        return (tuple(getattr(t.images, "shape", np.shape(t.images))), fm)

    def _admit(self):
        """Move pending tickets into free engine slots (a chunk boundary)."""
        eng = self.engine
        if self.admit_hold_s > 0:
            # burst coalescing, only while nothing decodes; stop holding once
            # the pending wave covers min(free slots, max_join_group)
            deadline = time.perf_counter() + self.admit_hold_s
            free = sum(1 for s in eng.slots if not s.busy)
            target = max(1, min(free, self.max_join_group))
            with self._cv:
                while (not self._stopped and self._pending and not self._live
                       and len(self._pending) < target):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
        while True:
            group: List[_Ticket] = []
            with self._cv:
                if not self._pending:
                    return
                head = self._pending[0]
                plen = head.ids.shape[1]
                if not eng.can_admit(plen):
                    # compact before giving up: finished requests leave dead
                    # blocks that compaction reclaims without touching live rows
                    eng.compact()
                if not eng.can_admit(plen):
                    # a prompt that can never fit fails instead of waiting
                    # forever: an empty engine admits the most it ever will
                    if eng.idle() and not self._live:
                        self._pending.popleft()
                        head.error = (f"prompt ({plen} tokens) exceeds engine capacity "
                                      f"(max_len={eng.s})")
                        head.event.set()
                        continue
                    return  # wait for live requests to finish
                free = sum(1 for s in eng.slots if not s.busy)
                key = self._shape_key(head)
                cap = max(1, min(free, self.max_join_group))
                limit = 1 << (cap.bit_length() - 1)  # power of two <= cap
                while (self._pending and len(group) < limit
                       and self._shape_key(self._pending[0]) == key
                       and eng.can_admit(max([self._pending[0].ids.shape[1]]
                                             + [g.ids.shape[1] for g in group]))):
                    group.append(self._pending.popleft())
                keep = 1 << (len(group).bit_length() - 1)  # round down to 2^k
                while len(group) > keep:
                    self._pending.appendleft(group.pop())
                self._in_flight_steps = [max(1, -(-t.max_new // eng.chunk)) for t in group]
            try:
                join_key = (len(group), eng._bucket(max(t.ids.shape[1] for t in group)))
                t_join = time.perf_counter()
                t_ns = time.perf_counter_ns()
                for t in group:
                    profiling.record("sched.queue", t.t_queued_ns, t_ns, t.rid)
                rows = eng.join_many([
                    dict(input_ids=t.ids, images=t.images, seed=t.seed, max_new=t.max_new,
                         temperature=t.temperature, top_p=t.top_p, frame_map=t.frame_map,
                         rid=t.rid)
                    for t in group])
                if join_key in self._seen_joins:
                    self._ewma("_join_s", time.perf_counter() - t_join)
                else:
                    self._seen_joins.add(join_key)
            except Exception as e:  # noqa: BLE001
                self._in_flight_steps = []
                if len(group) == 1:
                    group[0].error = str(e)
                    group[0].event.set()
                    continue
                # a failed GROUP join must not fail n requests: requeue them
                # and halve the width cap, down to solo joins
                self.max_join_group = max(1, len(group) // 2)
                with self._cv:
                    for t in reversed(group):
                        self._pending.appendleft(t)
                continue
            self._in_flight_steps = []
            for row, t in zip(rows, group):
                # the join produced the request's first token: TTFT ends here
                self.ttfts.append(time.perf_counter() - t.t_submit)
                self._live[row] = t
                self._stream(row, t)
                slot = eng.slots[row]
                if slot.done or len(slot.tokens) >= slot.max_new:
                    out = eng._finalize(slot)
                    eng.slots[row] = type(slot)()
                    self._finish(row, out)

    def _step_once(self):
        eng = self.engine
        if eng.pos + eng.chunk > eng.s:
            # cursor exhausted with rows live: compact first; truncation
            # (drain) only when even the compacted content fills the cache
            eng.compact()
        if eng.pos + eng.chunk > eng.s:
            done = eng.drain()
        else:
            t_step = time.perf_counter()
            done = eng.step()
            if self._step_warm:
                self._ewma("_step_s", time.perf_counter() - t_step)
            else:
                self._step_warm = True
        for row, out in done:
            self._finish(row, out)
        for row, t in list(self._live.items()):
            self._stream(row, t)

    def _stream(self, row, t: _Ticket):
        if t.on_tokens is None:
            return
        slot = self.engine.slots[row]
        if slot.busy and len(slot.tokens) > t.sent:
            t.on_tokens(list(slot.tokens[t.sent:]))
            t.sent = len(slot.tokens)

    def _finish(self, row, out: SampleOutput):
        t = self._live.pop(row)
        if t.on_tokens is not None:
            n = int(out.num_tokens[0])
            if n > t.sent:
                t.on_tokens([int(x) for x in out.sequences[0, t.sent:n]])
                t.sent = n
        t.output = out
        t.event.set()
