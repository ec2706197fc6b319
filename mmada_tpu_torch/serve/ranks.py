"""The serving engine over ranks: rank 0 decides, every rank computes.

The engine (`serve/engine.py`) batches on one host loop. Over a mesh of
several ranks each call of the sharded model is a program of collectives
that every rank must enter in the same order with the same inputs. So rank
0's dispatcher publishes every action that touches the model as one event,
in order, before it runs the action itself; ranks 1..N-1 run a follower loop
(`ServingEngine.follow`) that takes the events one by one and runs the same
calls on their shards, their outputs discarded:

  * ("run", task, kind, settings, payloads, seeds): a group's monolithic
    call, or the start of a chunked t2i / t2m / stepwise run (`task`);
  * ("stream", task, kind, settings, prompt length, max batch) and ("join",
    task, payloads, seeds): a continuous-batching stream and its new rows;
  * ("step", task): one chunk or window; ("keep", task, rows): the rows left
    after evicting cancelled requests (none: the task is aborted);
  * ("stop", fault): the end; every follower returns.

An event carries the inputs and the request seeds, never a decision a
follower must re-derive from its clock; a follower keeps no RNG state of its
own (every generator is seeded from a request's seed), and the mesh's
gathers and sums hand every rank the same logits, so every rank commits the
same tokens.

The channel is a key-value store on the hosts (`core/mesh.control_store`):
`ev/<n>` holds the n-th event, `seen/<r>` counts the events rank r has
taken, `fails/<r>` its failures, `fail/<r>/<k>` the k-th one's event and
traceback, and `failed/<n>` the followers that failed event n. A failure of
an event on every rank is the request's own (a bad argument fails alike
everywhere) and fails only its request. A failure on some ranks only parts
them: those left behind sit in the event's remaining collectives, which
would pair with the next event's and carry on with mixed data. So the
engine stops, with a `RankFault`, when

  * rank 0 failed an event and not every follower reports a failure of it
    within `timeout_s` (`Channel.shared_failure`, on rank 0's dispatcher);
  * a follower failed an event that rank 0 ran without error, or whose run
    on rank 0 has not ended `timeout_s` after the report (rank 0 waits in a
    collective the follower left);
  * a follower has not taken an event `timeout_s` after it was published.

`Watch`, a thread of rank 0, reads the followers' counters every `POLL_S`
for the last two. The engine then fails the requests in flight and queued,
stops, and publishes a stop that tells the followers of the fault; every
process then exits with an error (`app_torch.py`): a follower at the stop,
or, when it waits in a collective rank 0 left, at the collective's error
once rank 0's process is gone (or at the process group's timeout), so no
rank is left waiting.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import threading
import time
from typing import Callable, Optional

import torch.distributed as dist

from mmada_tpu_torch.core.mesh import CONTROL_TIMEOUT_S, control_store

logger = logging.getLogger(__name__)

#: seconds between the watch's reads of the followers' counters
POLL_S = 0.1
#: seconds an idle follower waits on the store at a time (one wait a period)
IDLE_WAIT_S = 3600.0


class RankFault(RuntimeError):
    """A rank failed an event alone, or fell behind: the ranks have parted,
    and the engine stops."""


class Channel:
    """The ordered events of rank 0 to the other ranks of the process group
    (every rank must build it: the store's address is sent over the group).
    With one rank there are no followers and `publish` only counts."""

    def __init__(self, timeout_s: float = CONTROL_TIMEOUT_S):
        self.timeout_s = float(timeout_s)
        initialized = dist.is_initialized()
        self.rank = dist.get_rank() if initialized else 0
        self.world = dist.get_world_size() if initialized else 1
        self.store = control_store(self.timeout_s) if self.world > 1 else None
        self.seq = 0            # events published (rank 0) or taken (a follower)
        self._lock = threading.Lock()
        self._published: dict = {}   # rank 0: event -> its publication time
        self._failures = 0

    @property
    def leader(self) -> bool:
        return self.rank == 0

    @property
    def followers(self) -> range:
        return range(1, self.world)

    def publish(self, event: tuple) -> int:
        """Rank 0: the next event; returns its number."""
        with self._lock:
            self.seq += 1
            if self.store is not None:
                self._published[self.seq] = time.monotonic()
                self.store.set(f"ev/{self.seq}", pickle.dumps(event))
            return self.seq

    def published_at(self, seq: int) -> Optional[float]:
        return self._published.get(seq)

    def forget(self, upto: int) -> None:
        """Rank 0: drop the events every follower has taken."""
        with self._lock:
            for seq in [s for s in self._published if s <= upto]:
                del self._published[seq]
                self.store.delete_key(f"ev/{seq}")

    def receive(self) -> tuple[int, tuple]:
        """A follower: the next event (waits while rank 0 is idle)."""
        key = f"ev/{self.seq + 1}"
        while True:
            try:
                self.store.wait([key], datetime.timedelta(seconds=IDLE_WAIT_S))
                break
            except dist.DistStoreError as e:   # an idle period ended; a lost store raises on
                if "timeout" not in str(e).lower():
                    raise
        self.seq += 1
        event = pickle.loads(self.store.get(key))
        self.store.add(f"seen/{self.rank}", 1)
        return self.seq, event

    def report(self, seq: int, trace: str) -> None:
        """A follower: event `seq` failed here, with this traceback."""
        self._failures += 1
        self.store.set(f"fail/{self.rank}/{self._failures}", pickle.dumps((seq, trace)))
        self.store.add(f"fails/{self.rank}", 1)
        self.store.add(f"failed/{seq}", 1)

    def shared_failure(self, seq: int) -> bool:
        """Rank 0, whose run of event `seq` failed: whether every follower
        reports a failure of it within the timeout."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            with self._lock:
                failed = self.store.add(f"failed/{seq}", 0)
            if failed >= len(self.followers):
                with self._lock:
                    self.store.delete_key(f"failed/{seq}")
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(POLL_S)


class Watch(threading.Thread):
    """Rank 0's watch over the followers (the module docstring).
    `outcome(seq)` is rank 0's own run of event `seq`: True (no error),
    False (an error) or None (not ended)."""

    def __init__(self, channel: Channel, outcome: Callable[[int], Optional[bool]],
                 on_fault: Callable[[BaseException], None]):
        super().__init__(daemon=True, name="serve-watch")
        self.channel, self.outcome, self.on_fault = channel, outcome, on_fault
        # a connection of its own: the dispatcher publishes on the channel's
        store = channel.store
        self.store = dist.TCPStore(store.host, store.port, channel.world, False,
                                   timeout=datetime.timedelta(seconds=channel.timeout_s))
        self._halt = threading.Event()

    def halt(self) -> None:
        self._halt.set()

    def run(self) -> None:
        try:
            self._watch()
        except Exception as e:   # the store itself is gone: nothing can be served
            if not self._halt.is_set():
                self.on_fault(RankFault(f"the control channel failed: {e!r}"))

    def _watch(self) -> None:
        ch, timeout = self.channel, self.channel.timeout_s
        read = {r: 0 for r in ch.followers}
        pending: list = []   # (rank, event, traceback, report time)
        while not self._halt.wait(POLL_S):
            now = time.monotonic()
            seen = {}
            for r in ch.followers:
                count = self.store.add(f"fails/{r}", 0)
                while read[r] < count:
                    read[r] += 1
                    seq, trace = pickle.loads(self.store.get(f"fail/{r}/{read[r]}"))
                    pending.append((r, seq, trace, now))
                seen[r] = self.store.add(f"seen/{r}", 0)
            for item in list(pending):
                r, seq, trace, t = item
                ok = self.outcome(seq)
                if ok is False:
                    pending.remove(item)   # the request's own error, on every rank
                elif ok is True or now - t > timeout:
                    return self._fault(RankFault(
                        f"rank {r} failed event {seq}, which rank 0 "
                        f"{'ran without error' if ok else f'had not ended within {timeout:g}s'}"
                        f":\n{trace}"))
            low = min(seen.values())
            behind = [r for r, s in seen.items() if s == low]
            published = ch.published_at(low + 1)
            if published is not None and now - published > timeout:
                return self._fault(RankFault(
                    f"rank(s) {behind} did not take event {low + 1} within {timeout:g}s"))
            ch.forget(low)

    def _fault(self, exc: RankFault) -> None:
        logger.error("%s", exc)
        self.on_fault(exc)
