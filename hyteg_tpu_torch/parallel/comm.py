"""Shard groups: the collectives of the sharded path.

A group is the port's counterpart of the JAX package's ``shard_map`` axis
(hyteg_tpu/parallel/spmd.py): ``rank`` and ``size`` (``axis_index`` and
the mesh size), ``all_reduce`` (``psum``, ``pmax``), ``all_gather`` (tiled
along axis 0), ``all_to_all``, and the paired sends of the neighbour
exchange (one ``ppermute`` per edge-colouring round) split into
``exchange_start`` / ``exchange_finish``, so that the overlapped apply
runs its interior cells in between.

Two groups run the same per-shard code:

* ``LocalGroup(size)``: S shards in one process on one device, one thread
  per shard; the shards take turns, each running to its next collective
  and handing on to the next rank (the counterpart of the JAX package's
  virtual devices). On a CUDA device every shard enqueues on the caller's
  current stream, so the order of enqueueing is the device's order and no
  events are needed. The exchange hands over copies within the process,
  so there is no overlap to win.
* ``DistGroup(...)``: one shard per process over ``torch.distributed``
  (NCCL on GPUs, gloo on the CPU); exchanges go through
  ``dist.batch_isend_irecv`` and ``exchange_finish`` waits on the handles.

Both take sums and maxima over shards from all-gathered parts in rank
order, so the two give the same bits wherever the per-shard work does,
and every shard holds the same reduced value.

Per-shard code receives its group as its first argument
(``group.run(fn, *per_shard_args)``); the arguments are lists aligned
with ``group.local_ranks`` (every rank for a LocalGroup, the process's own
for a DistGroup).
"""

from __future__ import annotations

import datetime
import threading
from typing import Callable, Sequence

import torch

#: seconds a LocalGroup shard waits for its turn before the group breaks
TURN_TIMEOUT = 900.0


def _ordered(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """Reduce per-shard parts in rank order (the same bits on every shard
    and under either group)."""
    acc = parts[0]
    for p in parts[1:]:
        if op == "sum":
            acc = acc + p
        elif op == "max":
            acc = torch.maximum(acc, p)
        else:
            raise ValueError(f"unknown reduction {op!r}")
    return acc.clone() if len(parts) == 1 else acc


class _Pending:
    """An exchange in flight: what ``exchange_finish`` returns, and for a
    DistGroup the handles it waits on."""

    def __init__(self, received, works=()):
        self.received = received
        self.works = works


class LocalShard:
    """One shard of a LocalGroup: the group interface for per-shard code.
    Made by the group; one per rank, kept for the group's lifetime."""

    def __init__(self, group: "LocalGroup", rank: int):
        self._g = group
        self.rank = rank
        self.size = group.size
        self._count = 0

    def _share(self, obj):
        """Post ``obj``, let the other shards run to this collective, and
        return every shard's object in rank order. Collectives alternate
        between two sets of slots: a shard posts the next collective's
        object into the other set, and reaches the one after that only
        when every shard has had its turn, that is, has read this one."""
        g = self._g
        k = self._count
        self._count += 1
        slots = g._slots[k % 2]
        slots[self.rank] = (k, obj)
        g._pass_on(self.rank)
        g._wait_turn(self.rank)
        if any(s is None or s[0] != k for s in slots):
            raise RuntimeError(
                f"shard {self.rank} is at collective {k}, another shard "
                "is not: per-shard code must run the same collectives")
        return [s[1] for s in slots]

    # Every tensor is posted as a copy: a shard may change its own tensor
    # in place as soon as it runs on, before the others have read the
    # posted one. On a CUDA device the copy is enqueued before that change
    # and before any reader, on the one stream.

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _ordered(self._share(t.clone()), op)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._share(t.clone()), dim=0)

    def all_to_all(self, chunks: Sequence[torch.Tensor]) -> list:
        """``chunks[j]`` goes to shard j; returns what each shard sent
        here, in rank order."""
        assert len(chunks) == self.size
        parts = self._share([c.clone() for c in chunks])
        return [parts[j][self.rank] for j in range(self.size)]

    def exchange_start(self, sends) -> _Pending:
        """``sends[r]``: None or (peer, tensor) for round r, where each
        shard has at most one peer per round and pairs are symmetric."""
        posted = self._share([None if s is None else (s[0], s[1].clone())
                              for s in sends])
        received = []
        for r, s in enumerate(sends):
            if s is None:
                received.append(None)
                continue
            peer_send = posted[s[0]][r]
            if peer_send is None or peer_send[0] != self.rank:
                raise RuntimeError(
                    f"exchange round {r}: shard {self.rank} sends to "
                    f"{s[0]}, which does not send back")
            received.append(peer_send[1])
        return _Pending(received)

    def exchange_finish(self, pending: _Pending) -> list:
        return pending.received


class LocalGroup:
    """S shards in this process, one thread each (see the module doc).

    The shards take turns: one runs at a time, from one collective to the
    next, then hands on to the next rank, so the threads never contend
    for the interpreter and a shard's host work runs at one thread's
    speed. Work on a CUDA device is enqueued in that turn order."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a group needs at least one shard, not {size}")
        self.size = size
        self._slots = ([None] * size, [None] * size)
        self._shards = [LocalShard(self, r) for r in range(size)]
        self._lock = threading.Lock()          # one run at a time
        self._turn_lock = threading.Lock()
        self._turn_cv = [threading.Condition(self._turn_lock)
                         for _ in range(size)]
        self._turn = 0
        self._done = [False] * size
        self._broken = False

    @property
    def local_ranks(self) -> list:
        return list(range(self.size))

    def _wait_turn(self, r: int) -> None:
        with self._turn_lock:
            while self._turn != r and not self._broken:
                if not self._turn_cv[r].wait(TURN_TIMEOUT):
                    self._broken = True
                    for cv in self._turn_cv:
                        cv.notify_all()
                    raise threading.BrokenBarrierError(
                        f"shard {r} waited {TURN_TIMEOUT} s for its turn")
            if self._broken:
                raise threading.BrokenBarrierError(f"shard {r}: group broken")

    def _pass_on(self, r: int, done: bool = False) -> None:
        """Hand the turn to the next rank that has not finished."""
        with self._turn_lock:
            self._done[r] = self._done[r] or done
            for i in range(1, self.size + 1):
                nxt = (r + i) % self.size
                if not self._done[nxt]:
                    self._turn = nxt
                    self._turn_cv[nxt].notify()
                    return

    def _abort(self) -> None:
        with self._turn_lock:
            self._broken = True
            for cv in self._turn_cv:
                cv.notify_all()

    def run(self, fn: Callable, *per_shard: Sequence) -> list:
        """``fn(shard, *args_r)`` on every shard, one thread each, taking
        turns; the results in rank order. The first error of any shard is
        raised here after every thread has stopped."""
        for a in per_shard:
            if len(a) != self.size:
                raise ValueError(f"{len(a)} per-shard arguments for "
                                 f"{self.size} shards")
        with self._lock:
            stream = (torch.cuda.current_stream()
                      if torch.cuda.is_available()
                      and torch.cuda.is_initialized() else None)
            results = [None] * self.size
            errors = [None] * self.size
            self._turn, self._broken = 0, False
            self._done = [False] * self.size
            self._slots = ([None] * self.size, [None] * self.size)
            for sh in self._shards:
                sh._count = 0

            def body(r):
                try:
                    self._wait_turn(r)
                    args = (a[r] for a in per_shard)
                    if stream is not None:
                        with torch.cuda.stream(stream):
                            results[r] = fn(self._shards[r], *args)
                    else:
                        results[r] = fn(self._shards[r], *args)
                    counts = {sh._count for sh in self._shards}
                    if len(counts) > 1 and not any(errors):
                        raise RuntimeError(
                            "shards ran different numbers of collectives: "
                            f"{[sh._count for sh in self._shards]}")
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors[r] = e
                    self._abort()
                finally:
                    self._pass_on(r, done=True)

            if self.size == 1:
                body(0)
            else:
                threads = [threading.Thread(target=body, args=(r,),
                                            name=f"shard-{r}")
                           for r in range(self.size)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            failed = [e for e in errors if e is not None]
            if failed:
                raise next((e for e in failed if not isinstance(
                    e, threading.BrokenBarrierError)), failed[0])
            return results


class DistGroup:
    """One shard per process over ``torch.distributed``.

    Joins the default process group, or initialises it from
    ``init_method`` (``tcp://host:port`` or ``file://path``), ``rank`` and
    ``world_size``. ``backend`` defaults to NCCL when ``device`` is a CUDA
    device, else gloo. Raises when the group cannot be formed."""

    def __init__(self, *, init_method: str | None = None,
                 rank: int | None = None, world_size: int | None = None,
                 backend: str | None = None, device=None,
                 timeout: float = 300.0):
        import torch.distributed as dist

        if not dist.is_available():
            raise RuntimeError("torch.distributed is not available")
        self.device = torch.device(device) if device is not None else None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if not dist.is_initialized():
            if init_method is None or rank is None or world_size is None:
                raise ValueError("DistGroup: no process group yet; pass "
                                 "init_method, rank and world_size")
            if backend is None:
                backend = ("nccl" if self.device is not None
                           and self.device.type == "cuda" else "gloo")
            dist.init_process_group(
                backend, init_method=init_method, rank=rank,
                world_size=world_size,
                timeout=datetime.timedelta(seconds=timeout))
        self._dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if self.size < 1:
            raise RuntimeError("DistGroup: empty process group")
        dist.barrier()  # every rank is in before the first send

    @property
    def local_ranks(self) -> list:
        return [self.rank]

    def run(self, fn: Callable, *per_shard: Sequence) -> list:
        """``fn(self, *args)`` for this process's shard; per-shard
        arguments are one-element lists (``local_ranks``)."""
        for a in per_shard:
            if len(a) != 1:
                raise ValueError("a DistGroup runs one shard per process: "
                                 "pass one-element per-shard lists")
        return [fn(self, *(a[0] for a in per_shard))]

    def _gather_parts(self, t: torch.Tensor) -> list:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._dist.all_gather(parts, t)
        return parts

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _ordered(self._gather_parts(t), op)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._gather_parts(t), dim=0)

    def all_to_all(self, chunks: Sequence[torch.Tensor]) -> list:
        """Pairwise sends (gloo has no all_to_all); each received chunk
        has the shape of the one sent to that shard."""
        dist = self._dist
        assert len(chunks) == self.size
        out, ops = [], []
        for j, c in enumerate(chunks):
            c = c.contiguous()
            if j == self.rank:
                out.append(c.clone())
                continue
            buf = torch.empty_like(c)
            out.append(buf)
            ops.append(dist.P2POp(dist.isend, c, j))
            ops.append(dist.P2POp(dist.irecv, buf, j))
        for w in (dist.batch_isend_irecv(ops) if ops else []):
            w.wait()
        return out

    def exchange_start(self, sends) -> _Pending:
        dist = self._dist
        ops, received = [], []
        for s in sends:
            if s is None:
                received.append(None)
                continue
            peer, t = s
            t = t.contiguous()
            buf = torch.empty_like(t)
            received.append(buf)
            ops.append(dist.P2POp(dist.isend, t, peer))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Pending(received, works)

    def exchange_finish(self, pending: _Pending) -> list:
        for w in pending.works:
            w.wait()
        return pending.received

    def close(self) -> None:
        """Leave the process group (after the last collective)."""
        if self._dist.is_initialized():
            self._dist.destroy_process_group()
