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

The stepwise demos (`submit_text_steps`, `submit_t2i_steps`: every step's
tokens, whole or streamed a chunk at a time through the future's `partial`
queue) are requests of their own kinds, run solo, so that every model call
of a server goes through the one dispatcher.

Over a mesh (`model.mesh`) the engine publishes every action that touches
the model on a control channel before it runs it (`serve/ranks.py`): rank
0 `start()`s the dispatcher and ranks 1..N-1 `follow()` it, running the
same calls on their shards. A rank that fails an event alone (rank 0 or a
follower) or falls behind fails the requests in flight and stops the engine
(`fault`, `on_fault`); with one rank the channel has no followers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Iterator, Optional

import numpy as np
import torch

from mmada_tpu_torch.core.mesh import CONTROL_TIMEOUT_S
from mmada_tpu_torch.sampling.text import num_transfer_schedule
from mmada_tpu_torch.serve import ranks
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


@dataclasses.dataclass(frozen=True)
class StepsSettings:
    """A stepwise demo's sampler keywords (sorted (name, value) pairs) and
    its chunk: 0 returns the whole trajectory, N > 0 streams it N steps at a
    time."""
    kwargs: tuple = ()
    segment: int = 0


@dataclasses.dataclass
class _Request:
    kind: str                      # 'text' | 'mmu' | 't2i' | 't2m' | 'text_steps' | 't2i_steps'
    payload: Any                   # prompt / frame ids, or the t2i / t2m tuple
    settings: Any
    future: Future
    seed: int
    enqueue_time: float
    partial: Optional[queue.Queue] = None   # a streamed demo's windows


def _shadow(kind, payload, settings, seed) -> _Request:
    """A follower's stand-in for one of rank 0's requests (its future is
    never read)."""
    return _Request(kind, payload, settings, Future(), seed, 0.0)


class _T2ITask:
    """A chunked t2i or t2m request, or a streamed stepwise demo, in flight:
    `step()` runs one window of its segmented run (the dispatcher's step /
    done / keep / fail_all protocol); a demo's window (`window(run)`) goes to
    its request's `partial` queue."""

    def __init__(self, run, grp, window=None):
        self.run = run
        self.grp = grp
        self.window = window

    @property
    def done(self) -> bool:
        return self.run.done

    @property
    def requests(self) -> list:
        return list(self.grp)

    def step(self):
        done = self.run.step()
        if self.window is not None:
            part = self.window(self.run)
            for r in self.grp:
                if r.partial is not None:
                    r.partial.put(part)
        if not done:
            return []
        if self.window is not None:
            return [(r, None) for r in self.grp]
        codes = self.run.codes.cpu().numpy()
        return [(r, codes[i]) for i, r in enumerate(self.grp)]

    def fail_all(self, exc: BaseException):
        for r in self.grp:
            _fail(r.future, exc)
        self.grp = []

    def kept_rows(self) -> Optional[list]:
        """None, or [] once every awaiting request is cancelled (the rows
        share one sampler call): then the run is aborted."""
        if self.grp and all(r.future.cancelled() for r in self.grp):
            return []
        return None

    def keep(self, rows: list) -> int:
        """Keep `rows` of the group; none aborts the run. Returns the
        number evicted."""
        n = len(self.grp) - len(rows)
        self.grp = [self.grp[i] for i in rows]
        if not rows:
            self.run.done = True
        return n


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

    @property
    def requests(self) -> list:
        return [st["req"] for st in self.rows]

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

    def kept_rows(self) -> Optional[list]:
        """The rows whose request was not cancelled, or None when that is
        every row."""
        keep = [i for i, st in enumerate(self.rows) if not st["req"].future.cancelled()]
        return None if len(keep) == len(self.rows) else keep

    def keep(self, rows: list) -> int:
        """Keep `rows`, evicting the others: the card stops paying for them
        from the next chunk. Returns the number evicted."""
        n = len(self.rows) - len(rows)
        self._keep(rows)
        return n


def _tensor(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([np.asarray(x).reshape(-1) for x in rows]),
                           dtype=torch.long).to(device)


def _text_window(run) -> np.ndarray:
    return run.last_states.cpu().numpy()


def _t2i_window(run) -> np.ndarray:
    return run.last_window.cpu().numpy()


#: the streamed demos' windows, by kind
_WINDOWS = {"text_steps": _text_window, "t2i_steps": _t2i_window}


def _call(model, kind: str, settings, payloads: list, seeds: list):
    """The model call of one group (every rank runs it alike): the outputs
    (numpy, one row a request), or a segmented run that the dispatcher steps
    a window at a time."""
    device = model.device

    def gen(seed):
        return torch.Generator(device).manual_seed(seed)

    def stack(idx):
        rows = [p[idx] for p in payloads]
        return None if rows[0] is None else _tensor(rows, device)

    if kind in ("text", "mmu"):
        gens = [gen(s) for s in seeds] if settings.stochastic else None
        return model.generate(
            _tensor(payloads, device), gen_length=settings.gen_length, steps=settings.steps,
            block_length=settings.block_length, temperature=settings.temperature,
            cfg_scale=settings.cfg_scale, remasking=settings.remasking, generator=gens,
            block_kv_cache=settings.block_kv_cache,
            parallel_threshold=settings.parallel_threshold,
            parallel_warmup_steps=settings.parallel_warmup_steps,
            cache_refresh_every=settings.cache_refresh_every,
        ).cpu().numpy()
    if kind == "t2i":
        if settings.segment_timesteps > 0 and settings.block_kv_cache:
            raise ValueError("segment_timesteps is exact-sampler only — unset block_kv_cache")
        kw = dict(uncond_input_ids=stack(1), attention_mask=stack(2),
                  uncond_attention_mask=stack(3), temperature=settings.temperature,
                  timesteps=settings.timesteps, guidance_scale=settings.guidance_scale,
                  num_vq_tokens=settings.num_vq_tokens, generator=gen(seeds[0]),
                  cfg_interval=settings.cfg_interval)
        if settings.segment_timesteps > 0:
            # chunked: the dispatcher interleaves other work between windows
            return model.t2i_segmented_run(stack(0), segment_timesteps=settings.segment_timesteps,
                                           **kw)
        return model.t2i_generate(stack(0), block_kv_cache=settings.block_kv_cache,
                                  cache_refresh_every=settings.cache_refresh_every,
                                  **kw).cpu().numpy()
    if kind == "t2m":
        if settings.segment_timesteps > 0 and settings.block_kv_cache:
            raise ValueError("segment_timesteps is exact-sampler only — unset block_kv_cache")
        kw = dict(attention_mask=stack(1), temperature=settings.temperature,
                  timesteps=settings.timesteps, num_motion_tokens=settings.num_motion_tokens,
                  generator=gen(seeds[0]))
        if settings.segment_timesteps > 0:
            return model.t2m_segmented_run(stack(0), segment_timesteps=settings.segment_timesteps,
                                           **kw)
        return model.t2m_generate(stack(0), block_kv_cache=settings.block_kv_cache,
                                  cache_refresh_every=settings.cache_refresh_every,
                                  **kw).cpu().numpy()
    if kind == "text_steps":
        kw = dict(settings.kwargs)
        g = gen(seeds[0]) if kw.get("temperature", 0.0) > 0 else None
        if settings.segment:
            return model.segmented_stepwise_run(_tensor(payloads, device), generator=g,
                                                segment_steps=settings.segment, **kw)
        return model.generate_stepwise(_tensor(payloads, device), generator=g,
                                       **kw).cpu().numpy()
    if kind == "t2i_steps":
        kw = dict(settings.kwargs, uncond_input_ids=stack(1), attention_mask=stack(2),
                  uncond_attention_mask=stack(3), generator=gen(seeds[0]))
        if settings.segment:
            return model.t2i_segmented_run(stack(0), segment_timesteps=settings.segment, **kw)
        return model.t2i_generate(stack(0), stepwise=True, **kw).cpu().numpy()
    raise ValueError(kind)


def partials(fut: Future) -> Iterator[np.ndarray]:
    """A streamed demo's windows as the dispatcher runs them, then its
    end (the future's error raised, if it failed)."""
    while True:
        try:
            yield fut.partial.get(timeout=0.05)
        except queue.Empty:
            if fut.done():
                while not fut.partial.empty():
                    yield fut.partial.get_nowait()
                fut.result()
                return


class ServingEngine:
    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 10.0,
                 max_queue: int = 256, min_chunk_device_ms: float = 25.0,
                 control_timeout_s: float = CONTROL_TIMEOUT_S):
        """Over a mesh every rank builds the engine (the control channel is
        made over the process group); rank 0 then `start()`s it, the others
        `follow()`."""
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
        # over a mesh: the control channel, rank 0's own outcome of each
        # event (the watch reads it), the requests of the action in flight
        # (a fault fails them), the fault that stopped the engine
        self.channel = (ranks.Channel(control_timeout_s)
                        if getattr(model, "mesh", None) is not None else None)
        self._tasks = itertools.count(1)
        self._outcomes: dict = {}
        self._busy: list = []
        self._watch: Optional[ranks.Watch] = None
        self._stop_published = False
        self.fault: Optional[BaseException] = None
        self.on_fault = None   # called once with the fault (the app exits on it)

    @property
    def leader(self) -> bool:
        """Rank 0 (or no mesh): this engine's dispatcher decides."""
        return self.channel is None or self.channel.leader

    # ------------------------------------------------------------ public
    def start(self):
        if not self.leader:
            raise RuntimeError(f"rank {self.channel.rank} follows rank 0: call follow()")
        if self.channel is not None and self.channel.world > 1:
            self._watch = ranks.Watch(self.channel, self._outcomes.get, self._on_fault)
            self._watch.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def follow(self) -> int:
        """Ranks 1..N-1: run rank 0's events on this rank's shards until its
        stop. Returns 0, or 1 when rank 0 stopped for a fault. An event that
        fails here is reported to rank 0 (with its traceback) and the loop
        goes on: a request's own error fails on every rank, and rank 0's
        watch stops every rank when only this one failed. When rank 0 failed
        alone and left this rank in a collective, the collective's error
        (once rank 0's process is gone) and then the channel's end the loop
        with an exception."""
        if self.leader:
            raise RuntimeError("rank 0 decides: call start()")
        tasks: dict = {}
        with torch.no_grad():
            while True:
                seq, event = self.channel.receive()
                if event[0] == "stop":
                    return 1 if event[1] else 0
                try:
                    self._replay(tasks, event)
                except Exception:
                    logger.exception("event %d (%s) failed", seq, event[0])
                    self.channel.report(seq, traceback.format_exc())
                    tasks.pop(event[1], None)   # rank 0's task fails (or every rank stops)

    def _replay(self, tasks: dict, event: tuple) -> None:
        """One of rank 0's events, on this rank's shards."""
        what, tid = event[0], event[1]
        if what == "run":
            _, _, kind, settings, payloads, seeds = event
            out = _call(self.model, kind, settings, payloads, seeds)
            if not isinstance(out, np.ndarray):
                tasks[tid] = _T2ITask(out, [_shadow(kind, p, settings, s) for p, s in
                                            zip(payloads, seeds)], _WINDOWS.get(kind))
            return
        if what == "stream":
            _, _, kind, settings, prompt_len, max_batch = event
            tasks[tid] = _Stream(self.model, kind, settings, prompt_len, max_batch)
            return
        task = tasks[tid]
        if what == "join":
            for payload, seed in zip(event[2], event[3]):
                task.join(_shadow(task.key[0], payload, task.settings, seed))
            return
        if what == "keep":
            task.keep(event[2])
        elif what == "step":
            task.step()
        else:
            raise ValueError(f"unknown event {what!r}")
        if task.done:
            del tasks[tid]

    @contextlib.contextmanager
    def _event(self, *event):
        """Publish `event` to the followers (over a mesh), then run its
        action here (the with-block); its outcome is kept for the watch.
        When the action fails here, over several ranks, and not every
        follower reports a failure of the same event within the channel's
        timeout, the ranks have parted (`serve/ranks.py`): the engine stops
        before the error reaches the caller."""
        if self.channel is None:
            yield
            return
        seq = self.channel.publish(event)
        try:
            yield
        except BaseException:
            shared = self.channel.world == 1 or self.channel.shared_failure(seq)
            self._settle(seq, False)
            if not shared:
                self._on_fault(ranks.RankFault(
                    f"rank 0 failed event {seq} ({event[0]}), which not every follower failed "
                    f"within {self.channel.timeout_s:g}s:\n{traceback.format_exc()}"))
            raise
        self._settle(seq, True)

    def _settle(self, seq: int, ok: bool) -> None:
        self._outcomes[seq] = ok
        self._outcomes.pop(seq - 4096, None)

    def _on_fault(self, exc: BaseException) -> None:
        """The ranks have parted (the watch, or `_event`): fail everything
        in flight and queued, stop, tell the followers, then `on_fault`."""
        if self.fault is not None:
            return
        self.fault = exc
        self._stop.set()
        self._gate.set()
        self._publish_stop()   # before any caller wakes to the failure and exits
        for r in list(self._busy):
            _fail(r.future, exc)
        for task in list(self._active):
            task.fail_all(exc)
        self._fail_queued(exc)
        if self.on_fault is not None:
            self.on_fault(exc)

    def _publish_stop(self) -> None:
        with self._stats_lock:
            first, self._stop_published = not self._stop_published, True
        if self.channel is not None and first:
            self.channel.publish(("stop", self.fault is not None))
        if self._watch is not None:
            self._watch.halt()

    def _fail_queued(self, exc: BaseException) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _fail(req.future, exc)

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
            # after a fault the dispatcher may wait in a collective a
            # follower left: it is not waited for
            self._thread.join(timeout=0 if self.fault is not None else 30)
        # resolve anything still queued so no caller hangs on result()
        self._fail_queued(RuntimeError("engine stopped"))
        self._publish_stop()

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

    def submit_text_steps(self, prompt_ids, seed: int = 0, segment_steps: int = 0,
                          **sampler) -> Future:
        """The text sampler's every step (`generate_stepwise`'s keywords in
        `sampler`; a generator from `seed` when the temperature is above 0):
        the future holds the `(steps, 1, L)` trajectory, or with
        `segment_steps` > 0 the chunks' `(W, 1, L)` states go to its
        `partial` queue as they run (read them with `partials`)."""
        return self._submit("text_steps", prompt_ids,
                            StepsSettings(tuple(sorted(sampler.items())), segment_steps), seed)

    def submit_t2i_steps(self, frame, uncond, seed: int = 0, attention_mask=None,
                         uncond_attention_mask=None, segment_timesteps: int = 0,
                         **sampler) -> Future:
        """Every t2i step's codes (`t2i_generate(stepwise=True)`'s keywords
        in `sampler`), whole or streamed a window at a time, as
        `submit_text_steps`."""
        return self._submit("t2i_steps", (frame, uncond, attention_mask, uncond_attention_mask),
                            StepsSettings(tuple(sorted(sampler.items())), segment_timesteps),
                            seed)

    def _submit(self, kind, payload, settings, seed) -> Future:
        fut: Future = Future()
        if kind in _WINDOWS and settings.segment:
            fut.partial = queue.Queue()
        if self._draining or self._stop.is_set():
            fut.set_exception(RuntimeError("engine draining"))
            return fut
        try:
            self._queue.put_nowait(_Request(kind, payload, settings, fut, seed, time.time(),
                                            getattr(fut, "partial", None)))
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
            if not self._active and self.fault is None:  # a last flush only if nothing would hang
                pending = self._collect(block=False)
                if pending:
                    self._flush(pending)
            while self._active:
                self._active.popleft().fail_all(self.fault or RuntimeError("engine stopped"))
            self._publish_stop()

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
        rows = task.kept_rows()
        if rows is not None:
            with self._event("keep", task.tid, rows):
                self._bump("cancelled", task.keep(rows))
        if task.done:
            return
        try:
            self._busy = task.requests
            with self._event("step", task.tid):
                finished = task.step()
            self._bump("chunks")
        except Exception as e:
            logger.exception("chunk failed")
            task.fail_all(e)
            return
        finally:
            self._busy = []
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
        # group by (kind, settings, frame length); t2i, t2m and the demos run
        # solo (one generator for the batch would tie a request's codes to
        # its row)
        groups: dict = {}
        for r in live:
            if r.kind in _WINDOWS:
                length, solo = None, id(r)
            elif r.kind == "t2m":
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
            n = min(len(reqs), self.max_batch - stream.occupancy)
            if n > 0:
                self._join(stream, reqs[:n])
                reqs = reqs[n:]
                self._bump("stream_joins", n)
        while reqs:
            take, reqs = reqs[:self.max_batch], reqs[self.max_batch:]
            # built (and its shapes checked) before the followers are told
            stream = _Stream(self.model, kind, settings, prompt_len, self.max_batch)
            stream.tid = next(self._tasks)
            with self._event("stream", stream.tid, kind, settings, prompt_len, self.max_batch):
                pass
            self._join(stream, take)
            self._active.append(stream)

    def _join(self, stream: "_Stream", reqs: list) -> None:
        with self._event("join", stream.tid, [r.payload for r in reqs], [r.seed for r in reqs]):
            for r in reqs:
                stream.join(r)

    def _run_monolithic(self, kind, settings, grp):
        tid = next(self._tasks)
        payloads, seeds = [r.payload for r in grp], [r.seed for r in grp]
        self._busy = grp
        try:
            with self._event("run", tid, kind, settings, payloads, seeds):
                out = _call(self.model, kind, settings, payloads, seeds)
        finally:
            self._busy = []
        if not isinstance(out, np.ndarray):
            task = _T2ITask(out, grp, _WINDOWS.get(kind))
            task.tid = tid
            self._active.append(task)
            return
        for i, r in enumerate(grp):
            self._record_latency(r)
            _deliver(r.future, out if kind in _WINDOWS else out[i])
