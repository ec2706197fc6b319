"""Batched mixed-modal serving engine.

Counterpart of `mmada_tpu/serve/engine.py` (`ServingEngine`, `:482`): a
request queue for text, MMU, t2i and t2m; one dispatcher thread owns the card
and runs every model call; callers get `concurrent.futures.Future`s.

  * Compatible requests (same kind, settings and frame length) that arrive
    together are micro-batched into one sampler call. Stochastic text and
    MMU rows each draw from their own generator seeded with the request's
    seed, so a row's answer is its solo run's whatever shares its batch
    (JAX's per-row keys, `_jit_text_per_row_keys`). t2i and t2m requests run
    solo: their MaskGIT samplers sample categorically from one generator.
  * `segment_steps` (text, MMU) and `segment_timesteps` (t2i, t2m) run a request
    in chunks, and the dispatcher round-robins the chunks of the requests in
    flight with newly arrived work, so a heavy request yields the card every
    chunk. Chunked text and MMU requests with one key (kind, settings, frame
    length) share a continuous-batching stream (`_Stream`): each row at its
    own block and step, so a request joins a running stream at a chunk
    boundary and leaves it when done. The chunk guard runs a request whose
    chunk would cost less than `min_chunk_device_ms` of card time as one call
    instead (`_est_chunk_device_s`).
  * The queue is bounded (submissions past `max_queue` fail at once),
    `Future.cancel()` works until delivery (queued requests are dropped, a
    stream frees the row at its next chunk), and `stop(drain=True)` finishes
    accepted work before it stops.

Where the port differs from JAX: XLA compiled one program per batch shape,
so JAX pads every batch to a power-of-two bucket with copies of its last row
and sizes a stream's slot pool by the same buckets. On the card every row of
a batch costs its compute, so the port runs a group at its own size and a
stream's rows are exactly its requests (up to `max_batch`); a padding row or
free slot never exists, and the stats keep JAX's keys and meanings. Results
are numpy arrays, as JAX's are.

The dispatcher runs its calls under `torch.no_grad()` (grad mode is per
thread); an error in a call fails the futures of its group or stream.
`pause()` / `resume()` hold the dispatcher between calls, so a caller can
queue several requests and release them as one batch.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Optional

import numpy as np
import torch

from mmada_tpu_torch.sampling.text import num_transfer_schedule
from mmada_tpu_torch.utils.flops import forward_matmul_flops_per_token

logger = logging.getLogger(__name__)

#: The achieved matmul rate of the full-width 8B's exact forward on the card:
#: 488-498 TFLOP/s for the 1,194-token MMU frame in bf16 on an NVIDIA H100
#: 80GB HBM3 at 700 W, in three runs (`chip_smoke.py`'s engine phase prints
#: it as "the chunk guard's rate"; PERF.md section 5). The chunk guard prices
#: a chunk at it.
CARD_FLOPS_PER_S = 4.9e14


def _deliver(fut: Future, value) -> None:
    """set_result tolerant of a cancel() that races in: futures are never
    marked running, so a client may cancel up to delivery."""
    if fut.cancelled():
        return
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


def _fail(fut: Future, exc: BaseException) -> None:
    if fut.done():
        return
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


@dataclasses.dataclass(frozen=True)
class TextSettings:
    gen_length: int = 128
    steps: int = 128
    block_length: int = 128
    temperature: float = 0.0
    cfg_scale: float = 0.0
    remasking: str = "low_confidence"  # or 'random'
    block_kv_cache: Any = False        # False | True | "int8": the cached decode
    parallel_threshold: float = 0.0    # tau-parallel commits (opt-in)
    parallel_warmup_steps: int = 0     # tau fires only after K steps a block
    cache_refresh_every: int = 0       # the cached decode's refresh cadence
    # > 0: run the exact sampler as chunks of at most N steps, interleaved
    # with other work (a continuous-batching stream); the same tokens
    segment_steps: int = 0

    @property
    def stochastic(self) -> bool:
        # 'random' remasking draws confidence noise even at temperature 0
        return self.temperature > 0 or self.remasking == "random"


@dataclasses.dataclass(frozen=True)
class T2ISettings:
    timesteps: int = 15
    guidance_scale: float = 3.5
    temperature: float = 1.0
    num_vq_tokens: int = 1024
    block_kv_cache: Any = False        # the cached decode (opt-in)
    cache_refresh_every: int = 0
    # > 0: run the MaskGIT loop as windows of at most N steps, interleaved
    # with other work; the same codes
    segment_timesteps: int = 0
    # guidance only for steps in [lo, hi) step fractions (exact sampler only)
    cfg_interval: tuple = (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class T2MSettings:
    timesteps: int = 18
    temperature: float = 1.0
    num_motion_tokens: int = 256
    block_kv_cache: Any = False        # the cached decode (opt-in)
    cache_refresh_every: int = 0
    # > 0: run the MotionGIT loop as windows of at most N steps, interleaved
    # with other work; the same codes (exact sampler only)
    segment_timesteps: int = 0


@dataclasses.dataclass
class _Request:
    kind: str                      # 'text' | 'mmu' | 't2i' | 't2m'
    payload: Any                   # prompt / frame ids, or the t2i / t2m tuple
    settings: Any
    future: Future
    seed: int
    enqueue_time: float


class _T2ITask:
    """A chunked t2i or t2m request in flight: `step()` runs one window of
    its `SegmentedT2IRun` / `SegmentedT2MRun` (the dispatcher's step / done /
    fail_all protocol)."""

    def __init__(self, run, grp):
        self.run = run
        self.grp = grp

    @property
    def done(self) -> bool:
        return self.run.done

    def step(self):
        if self.run.step():
            codes = self.run.codes.cpu().numpy()
            return [(r, codes[i]) for i, r in enumerate(self.grp)]
        return []

    def fail_all(self, exc: BaseException):
        for r in self.grp:
            _fail(r.future, exc)
        self.grp = []

    def evict_cancelled(self) -> int:
        """Abort once every awaiting request is cancelled (the rows share one
        sampler call)."""
        if self.grp and all(r.future.cancelled() for r in self.grp):
            n = len(self.grp)
            self.grp = []
            self.run.done = True
            return n
        return 0


class _Stream:
    """Continuous batching of chunked exact-sampler requests with one key
    (kind, settings, frame length). Each row advances on its own: its block,
    its chunk within the block, its block's transfer schedule and (stochastic)
    its own generator. A chunk is `C = min(segment_steps, steps_per_block)`
    steps; a block whose steps are not a multiple of C ends with padding
    steps, which commit nothing (no [MASK] is left after the block's real
    steps) and draw nothing (`text_sampling.run_rows`). A request joins at any
    chunk boundary while the stream holds fewer than `max_batch` rows, and its
    row is removed when it finishes or is cancelled, so every row of a chunk
    is a live request."""

    def __init__(self, model, kind, settings: TextSettings, prompt_len: int, max_batch: int):
        # the whole request's shape checks, as the monolithic sampler's
        model._semiar_config(settings.gen_length, settings.steps, settings.block_length,
                             settings.temperature, settings.cfg_scale, settings.remasking,
                             settings.parallel_threshold, settings.parallel_warmup_steps)
        self.key = (kind, settings, prompt_len)
        self.settings = settings
        self.max_batch = max_batch
        self.device = model.device
        self.nb = settings.gen_length // settings.block_length
        self.spb = settings.steps // self.nb
        self.C = min(settings.segment_steps, self.spb)
        self.cpb = -(-self.spb // self.C)      # chunks a block
        self.spb_pad = self.cpb * self.C
        self.P = prompt_len
        self.L = prompt_len + settings.gen_length
        self._mask_id = model.vocab.mask_token_id
        self._runner = model.segmented_chunk_runner(
            steps_per_block=self.spb, block_length=settings.block_length,
            temperature=settings.temperature, cfg_scale=settings.cfg_scale,
            remasking=settings.remasking, parallel_threshold=settings.parallel_threshold,
            parallel_warmup_steps=settings.parallel_warmup_steps,
        )
        self.rows: list[dict] = []
        self.x = torch.zeros((0, self.L), dtype=torch.long, device=self.device)

    @property
    def occupancy(self) -> int:
        return len(self.rows)

    @property
    def done(self) -> bool:
        return not self.rows

    def join(self, req: _Request) -> bool:
        """Admit `req` as a new row; False when the stream is full."""
        if len(self.rows) >= self.max_batch:
            return False
        prompt = torch.as_tensor(np.asarray(req.payload).reshape(-1), dtype=torch.long)
        row = torch.cat([prompt, torch.full((self.settings.gen_length,), self._mask_id,
                                            dtype=torch.long)])
        self.x = torch.cat([self.x, row[None].to(self.device)])
        gen = (torch.Generator(self.device).manual_seed(req.seed)
               if self.settings.stochastic else None)
        self.rows.append({"req": req, "block": 0, "ci": 0, "transfers": None, "gen": gen})
        return True

    def _block_transfers(self, i: int) -> torch.Tensor:
        """The row's block schedule, as its solo run computes it, padded with
        zeros to `spb_pad` steps."""
        bs = self.P + self.rows[i]["block"] * self.settings.block_length
        cnt = (self.x[i, bs:bs + self.settings.block_length] == self._mask_id).sum()
        tr = num_transfer_schedule(cnt[None], self.spb)[0]
        return torch.cat([tr, tr.new_zeros(self.spb_pad - self.spb)])

    def step(self) -> list:
        """Run ONE chunk over the rows; return the (request, tokens) pairs
        that finished."""
        ends, trs, offs = [], [], []
        for i, st in enumerate(self.rows):
            if st["transfers"] is None:
                st["transfers"] = self._block_transfers(i)
            c0 = st["ci"] * self.C
            ends.append(self.P + (st["block"] + 1) * self.settings.block_length)
            trs.append(st["transfers"][c0:c0 + self.C])
            offs.append(c0)
        pi = self.x != self._mask_id
        pi[:, self.P:] = False
        gens = [st["gen"] for st in self.rows] if self.settings.stochastic else None
        self.x = self._runner(self.x, pi, torch.tensor(ends, device=self.device),
                              torch.stack(trs), offs, gens)
        finished = []
        for i, st in enumerate(self.rows):
            st["ci"] += 1
            if st["ci"] == self.cpb:
                st["ci"] = 0
                st["block"] += 1
                st["transfers"] = None
                if st["block"] == self.nb:
                    finished.append(i)
        if not finished:
            return []
        xs = self.x.cpu().numpy()
        out = [(self.rows[i]["req"], xs[i]) for i in finished]
        self._keep([i for i in range(len(self.rows)) if i not in finished])
        return out

    def _keep(self, keep: list) -> None:
        self.rows = [self.rows[i] for i in keep]
        self.x = self.x[torch.tensor(keep, dtype=torch.long, device=self.device)]

    def fail_all(self, exc: BaseException):
        for st in self.rows:
            _fail(st["req"].future, exc)
        self._keep([])

    def evict_cancelled(self) -> int:
        """Remove the rows whose request was cancelled: the card stops paying
        for them from the next chunk."""
        keep = [i for i, st in enumerate(self.rows) if not st["req"].future.cancelled()]
        n = len(self.rows) - len(keep)
        if n:
            self._keep(keep)
        return n


def check_one_rank(model) -> None:
    """The engine batches on one rank's host loop: a model whose mesh spans
    more than one rank would need rank 0 to decide each batch and send it to
    the others (ROADMAP A.12b)."""
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.mesh.numel() > 1:
        raise NotImplementedError(
            f"the serving engine over a mesh of {mesh.mesh.numel()} ranks is not ported "
            "(ROADMAP A.12b: rank 0 would decide each batch and broadcast it); serve "
            "through the command lines, or with parallel.serving=none")


class ServingEngine:
    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 10.0,
                 max_queue: int = 256, min_chunk_device_ms: float = 25.0):
        check_one_rank(model)
        self.model = model
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        # the chunk guard: a chunk whose estimated card time is under this
        # floor costs more in its return to the host loop than chunking
        # gains; such requests run as one call. 0 always chunks.
        self.min_chunk_device_s = min_chunk_device_ms / 1000.0
        self._chunk_guard_logged: set = set()
        # bounded queue: submit fails at once under overload
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        # chunked work in flight, round-robined a chunk at a time (dispatcher
        # thread only)
        self._active: deque = deque()
        self._stop = threading.Event()
        self._gate = threading.Event()     # set: the dispatcher may run
        self._gate.set()
        self._parked = threading.Event()   # set: the dispatcher waits at the gate
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "chunks": 0, "stream_joins": 0, "cancelled": 0,
                      "chunk_guard_skips": 0}
        self._draining = False
        # dispatcher-owned: True only when nothing is in flight and the queue
        # was empty at the end of a loop iteration (drain waits on it)
        self._quiescent = True
        # rolling completion latencies per kind (last 256), for /stats
        self._latencies: dict = {}

    # ------------------------------------------------------------ public
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        """Started and not stopped: submissions are served."""
        return self._thread is not None and not self._stop.is_set()

    def pause(self, timeout_s: float = 60.0):
        """Hold the dispatcher between calls; returns once it waits (work in
        flight stays where it is). Requests submitted meanwhile queue up."""
        self._gate.clear()
        if self._thread is not None and self._thread.is_alive():
            if not self._parked.wait(timeout_s):
                raise TimeoutError("the dispatcher did not reach its gate")

    def resume(self):
        """Release the dispatcher: what queued while it was held is collected
        together (up to `max_batch` a batch)."""
        self._gate.set()

    def stop(self, drain: bool = False, drain_timeout_s: float = 300.0):
        """`drain=True`: reject new submissions, finish queued and in-flight
        work, then stop; nothing accepted fails unless the drain times out.
        Default: fail everything still pending."""
        if drain:
            self._draining = True
            self._gate.set()
            deadline = time.time() + drain_timeout_s
            while (not self._quiescent and time.time() < deadline
                   and self._thread and self._thread.is_alive()):
                time.sleep(0.01)
        self._stop.set()
        self._gate.set()
        if self._thread:
            self._thread.join(timeout=30)
        # resolve anything still queued so no caller hangs on result()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _fail(req.future, RuntimeError("engine stopped"))

    def submit_text(self, prompt_ids, settings: TextSettings, seed: int = 0) -> Future:
        return self._submit("text", prompt_ids, settings, seed)

    def submit_mmu(self, frame_ids, settings: TextSettings, seed: int = 0) -> Future:
        return self._submit("mmu", frame_ids, settings, seed)

    def submit_t2m(self, frame_ids, settings: T2MSettings, seed: int = 0,
                   attention_mask=None) -> Future:
        """One t2m frame (`UniversalPrompting.t2m`, its motion span masked);
        the future holds its `(num_motion_tokens,)` raw motion codes."""
        return self._submit("t2m", (frame_ids, attention_mask), settings, seed)

    def submit_t2i(self, frame, uncond, settings: T2ISettings, seed: int = 0,
                   attention_mask=None, uncond_attention_mask=None) -> Future:
        return self._submit("t2i", (frame, uncond, attention_mask, uncond_attention_mask),
                            settings, seed)

    def _submit(self, kind, payload, settings, seed) -> Future:
        fut: Future = Future()
        if self._draining or self._stop.is_set():
            fut.set_exception(RuntimeError("engine draining"))
            return fut
        try:
            self._queue.put_nowait(_Request(kind, payload, settings, fut, seed, time.time()))
        except queue.Full:
            fut.set_exception(RuntimeError("serving queue full — backpressure"))
            return fut
        self._bump("requests")
        return fut

    def _record_latency(self, req: _Request):
        with self._stats_lock:
            dq = self._latencies.setdefault(req.kind, deque(maxlen=256))
            dq.append(time.time() - req.enqueue_time)

    def latency_stats(self) -> dict:
        """Rolling per-kind completion latency (seconds since enqueue):
        count / p50 / p95 over the last 256 requests of each kind."""
        out = {}
        with self._stats_lock:
            items = {k: sorted(v) for k, v in self._latencies.items()}
        for kind, xs in items.items():
            out[kind] = {
                "count": len(xs),
                "p50_s": round(xs[len(xs) // 2], 4),
                "p95_s": round(xs[min(len(xs) - 1, int(len(xs) * 0.95))], 4),
            }
        return out

    def _bump(self, name: str, n: int = 1):
        with self._stats_lock:
            self.stats[name] += n

    # --------------------------------------------------------- dispatcher
    def _loop(self):
        with torch.no_grad():
            while not self._stop.is_set():
                if not self._gate.is_set():
                    self._parked.set()
                    self._gate.wait()
                    self._parked.clear()
                    continue
                # with chunked work in flight, poll the queue without waiting
                pending = self._collect(block=not self._active)
                if pending:
                    self._flush(pending)
                if self._active:
                    self._step_active()
                self._quiescent = not self._active and self._queue.empty()
            if not self._active:  # a last flush only if nothing would hang
                pending = self._collect(block=False)
                if pending:
                    self._flush(pending)
            while self._active:
                self._active.popleft().fail_all(RuntimeError("engine stopped"))

    def _collect(self, block: bool) -> list:
        """The queued requests, up to `max_batch`: what is already queued,
        then what arrives within `max_wait` of the first one's enqueue."""
        pending: list = []
        try:
            pending.append(self._queue.get(timeout=0.05 if block else 0.0))
        except queue.Empty:
            return pending
        while len(pending) < self.max_batch:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        deadline = pending[0].enqueue_time + self.max_wait
        while len(pending) < self.max_batch and time.time() < deadline:
            try:
                pending.append(self._queue.get(timeout=max(0.0, deadline - time.time())))
            except queue.Empty:
                break
        return pending

    def _step_active(self):
        """Advance the oldest chunked task by ONE chunk, then requeue it
        unless it is done: round-robin at chunk granularity."""
        task = self._active.popleft()
        evicted = task.evict_cancelled()
        if evicted:
            self._bump("cancelled", evicted)
        if task.done:
            return
        try:
            finished = task.step()
            self._bump("chunks")
        except Exception as e:
            logger.exception("chunk failed")
            task.fail_all(e)
            return
        for req, tokens in finished:
            self._record_latency(req)
            _deliver(req.future, tokens)
        if not task.done:
            self._active.append(task)

    def _flush(self, requests: list):
        # drop requests cancelled while queued
        live = [r for r in requests if not r.future.cancelled()]
        if len(live) != len(requests):
            self._bump("cancelled", len(requests) - len(live))
        if not live:
            return
        # group by (kind, settings, frame length); t2i and t2m run solo (one
        # generator for the batch would tie a request's codes to its row)
        groups: dict = {}
        for r in live:
            if r.kind == "t2m":
                length = (np.asarray(r.payload[0]).shape[-1], r.payload[1] is not None)
                solo = id(r)
            elif r.kind == "t2i":
                length = (np.asarray(r.payload[0]).shape[-1], np.asarray(r.payload[1]).shape[-1],
                          r.payload[2] is not None, r.payload[3] is not None)
                solo = id(r)
            else:
                length = np.asarray(r.payload).shape[-1]
                solo = None
            groups.setdefault((r.kind, r.settings, length, solo), []).append(r)
        for (kind, settings, _, _), grp in groups.items():
            try:
                self._run_group(kind, settings, grp)
            except Exception as e:
                logger.exception("batch failed")
                for r in grp:
                    _fail(r.future, e)

    def _run_group(self, kind: str, settings, grp: list):
        n = len(grp)
        if kind in ("text", "mmu") and settings.segment_steps > 0:
            if settings.block_kv_cache:
                raise ValueError("segment_steps is exact-sampler only — unset block_kv_cache")
            prompt_len = int(np.asarray(grp[0].payload).reshape(-1).shape[0])
            # the chunk runs every row of the group, so price them all
            est = self._est_chunk_device_s(settings, prompt_len) * min(n, self.max_batch)
            if 0 < est < self.min_chunk_device_s:
                gk = (kind, settings)
                if gk not in self._chunk_guard_logged:
                    self._chunk_guard_logged.add(gk)
                    logger.info(
                        "segment_steps=%d ignored for %s op (est. chunk device time %.1f ms "
                        "< %.0f ms floor): running monolithic", settings.segment_steps, kind,
                        est * 1e3, self.min_chunk_device_s * 1e3)
                self._bump("chunk_guard_skips")
            else:
                self._admit_chunked(kind, settings, grp, prompt_len)
                return
        self._bump("batches")
        self._bump("batched_requests", n)
        self._run_monolithic(kind, settings, grp)

    def _est_chunk_device_s(self, settings, prompt_len: int) -> float:
        """Estimated card seconds of ONE chunk of this request (one row):
        the matmul FLOPs of its forwards at `CARD_FLOPS_PER_S`. 0.0 when the
        model has no config (a test double), which disables the guard."""
        cfg = getattr(self.model, "cfg", None)
        if cfg is None or settings.block_length <= 0:
            return 0.0
        L = prompt_len + settings.gen_length
        nb = max(settings.gen_length // settings.block_length, 1)
        spb = max(settings.steps // nb, 1)
        c = min(settings.segment_steps, spb)
        rows = 2 if settings.cfg_scale > 0 else 1
        flops_per_step = rows * L * forward_matmul_flops_per_token(
            cfg, L, settings.block_length, getattr(cfg, "embedding_size", None) or cfg.vocab_size)
        return c * flops_per_step / CARD_FLOPS_PER_S

    def _admit_chunked(self, kind, settings, grp, prompt_len):
        skey = (kind, settings, prompt_len)
        reqs = list(grp)
        for stream in self._active:
            if not isinstance(stream, _Stream) or stream.key != skey:
                continue
            while reqs and stream.join(reqs[0]):
                reqs.pop(0)
                self._bump("stream_joins")
        while reqs:
            take, reqs = reqs[:self.max_batch], reqs[self.max_batch:]
            stream = _Stream(self.model, kind, settings, prompt_len, self.max_batch)
            for r in take:
                stream.join(r)
            self._active.append(stream)

    def _tensor(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.stack([np.asarray(x).reshape(-1) for x in rows]),
                               dtype=torch.long).to(self.model.device)

    def _run_monolithic(self, kind, settings, grp):
        if kind in ("text", "mmu"):
            prompts = self._tensor([r.payload for r in grp])
            gens = ([torch.Generator(self.model.device).manual_seed(r.seed) for r in grp]
                    if settings.stochastic else None)
            out = self.model.generate(
                prompts, gen_length=settings.gen_length, steps=settings.steps,
                block_length=settings.block_length, temperature=settings.temperature,
                cfg_scale=settings.cfg_scale, remasking=settings.remasking, generator=gens,
                block_kv_cache=settings.block_kv_cache,
                parallel_threshold=settings.parallel_threshold,
                parallel_warmup_steps=settings.parallel_warmup_steps,
                cache_refresh_every=settings.cache_refresh_every,
            ).cpu().numpy()
            for i, r in enumerate(grp):
                self._record_latency(r)
                _deliver(r.future, out[i])
        elif kind == "t2i":
            def stack(idx):
                rows = [r.payload[idx] for r in grp]
                return None if rows[0] is None else self._tensor(rows)

            if settings.segment_timesteps > 0 and settings.block_kv_cache:
                raise ValueError("segment_timesteps is exact-sampler only — unset block_kv_cache")
            kw = dict(uncond_input_ids=stack(1), attention_mask=stack(2),
                      uncond_attention_mask=stack(3), temperature=settings.temperature,
                      timesteps=settings.timesteps, guidance_scale=settings.guidance_scale,
                      num_vq_tokens=settings.num_vq_tokens,
                      generator=torch.Generator(self.model.device).manual_seed(grp[0].seed),
                      cfg_interval=settings.cfg_interval)
            if settings.segment_timesteps > 0:
                # chunked: the dispatcher interleaves other work between windows
                run = self.model.t2i_segmented_run(
                    stack(0), segment_timesteps=settings.segment_timesteps, **kw)
                self._active.append(_T2ITask(run, grp))
                return
            codes = self.model.t2i_generate(
                stack(0), block_kv_cache=settings.block_kv_cache,
                cache_refresh_every=settings.cache_refresh_every, **kw).cpu().numpy()
            for i, r in enumerate(grp):
                self._record_latency(r)
                _deliver(r.future, codes[i])
        elif kind == "t2m":
            frame = self._tensor([grp[0].payload[0]])
            attn = None if grp[0].payload[1] is None else self._tensor([grp[0].payload[1]])
            if settings.segment_timesteps > 0 and settings.block_kv_cache:
                raise ValueError("segment_timesteps is exact-sampler only — unset block_kv_cache")
            kw = dict(attention_mask=attn, temperature=settings.temperature,
                      timesteps=settings.timesteps,
                      num_motion_tokens=settings.num_motion_tokens,
                      generator=torch.Generator(self.model.device).manual_seed(grp[0].seed))
            if settings.segment_timesteps > 0:
                run = self.model.t2m_segmented_run(
                    frame, segment_timesteps=settings.segment_timesteps, **kw)
                self._active.append(_T2ITask(run, grp))
                return
            codes = self.model.t2m_generate(
                frame, block_kv_cache=settings.block_kv_cache,
                cache_refresh_every=settings.cache_refresh_every, **kw).cpu().numpy()
            for i, r in enumerate(grp):
                self._record_latency(r)
                _deliver(r.future, codes[i])
        else:
            raise ValueError(kind)
