"""Device loops: the port's counterpart of ``lax.while_loop`` and
``lax.fori_loop``.

The JAX package compiles its solver's and pose graph's loops into one XLA
program, so the device runs every round back to back and the host reads
nothing. Here a loop runs in chunks of rounds:

* ``while_chunks`` runs ``min(chunk, bound - trips)`` rounds per host read
  of a device-side "any row live" flag, so a loop reads about
  ``rounds / chunk`` flags, not one per round. The body must keep a row
  that is no longer live as it is (every loop here freezes its rows by
  ``torch.where`` on their live masks, or because their state is a fixed
  point of the round), so the rounds a chunk runs past a row's exit
  change no bit.
* ``fori`` runs a fixed trip count and reads nothing.

On a CUDA device one chunk is captured once as a ``torch.cuda.CUDAGraph``
and then replayed. The first call of a loop at a new cache key runs its
first chunk uncaptured on the capture stream (the warm-up: B2's per-stream
scratch and cuBLAS's workspace are set up there) and keeps its result,
then captures the chunk; every later chunk replays. The key is the
loop's name, the body's and the flag's code, the Python values they close
over, the shapes, dtypes, strides and device of the loop's tensors and the
chunk length. A body reads tensors only through its ``consts`` and
``state`` arguments, which are copied into the graph's static buffers: a
body that closes over a tensor raises TypeError (its graph would read that
tensor's memory on every later call). What leaves the helper is copied
out of the static buffers. All graphs share one memory pool per device
and are never replayed at once; at most ``MAX_GRAPHS`` are kept.

On the CPU, where there is no capture, and for a body the caller marks
uncapturable (``graph=False``, with its reason at the call), the same
chunks run uncaptured. ``eager_loops()`` runs them uncaptured on the card
too: it is for the tests and ``chip_smoke.py``, which hold the two routes
bit for bit; nothing on the main path enters it.

Counters: ``LOOPS[name]`` holds the loop's rounds, flag reads, captures
and replays since ``reset_loops()``, and after a capture ``graph_bytes``:
the bytes of the graph's static buffers plus what the device's reserved
memory grew by during the capture (the pool's new segments; a capture
that fits in segments the pool already holds adds none). ``CAPTURED``
sums the captures and their bytes since the process started
(``reset_loops`` leaves it): cumulative, graphs since evicted or cleared
included. ``held()`` gives the graphs kept now and the sum of their
capture bytes, for reports. ``ops.launch.LAUNCHES`` counts on the
host, so a capture's kernel launches are taken back out of it and added
again at each replay: a path counts the same launches either way.
"""

from __future__ import annotations

import contextlib
from collections import Counter, OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES

MAX_GRAPHS = 64         # captured chunks kept (least recently used go)

LOOPS: dict = {}        # name -> {"rounds", "reads", "captures", "replays"}
CAPTURED = {"graphs": 0, "bytes": 0}    # every capture since the start

_GRAPHS: OrderedDict = OrderedDict()
_POOLS: dict = {}       # device index -> graph memory pool
_STREAMS: dict = {}     # device index -> capture stream
_MODE = {"eager": False, "chunk": None}


def reset_loops() -> None:
    LOOPS.clear()


def _count(name: str, **kw) -> None:
    c = LOOPS.setdefault(name, {"rounds": 0, "reads": 0, "captures": 0,
                                "replays": 0})
    for k, v in kw.items():
        c[k] = c.get(k, 0) + v


@contextlib.contextmanager
def eager_loops(chunk: Optional[int] = None):
    """Run every loop uncaptured, on the card too; with ``chunk``, every
    loop reads its flag once per ``chunk`` rounds (1: once per round, as
    the loops ran before the graphs). For the tests and ``chip_smoke.py``
    only."""
    saved = dict(_MODE)
    _MODE.update(eager=True, chunk=chunk)
    try:
        yield
    finally:
        _MODE.update(saved)


def clear_graphs() -> None:
    """Drop every captured chunk (the next call of each loop captures
    again) and their memory pools: a pool that no graph holds any more
    is released, and a capture into it would fail."""
    _GRAPHS.clear()
    _POOLS.clear()


def _value_key(v):
    if torch.is_tensor(v):
        raise TypeError("a loop body closes over a tensor: pass it in the "
                        "loop's consts or state")
    if v is None or isinstance(v, (bool, int, float, str, torch.dtype,
                                   torch.device)):
        return (type(v), v)
    if hasattr(v, "__code__"):
        return _fn_key(v)
    if isinstance(v, (tuple, list)):
        return tuple(_value_key(x) for x in v)
    return v                    # hashable by identity (a process group)


def _fn_key(fn: Callable):
    """A function's code and the values its closure holds, recursively."""
    return (fn.__code__, tuple(_value_key(c.cell_contents)
                               for c in fn.__closure__ or ()))


def _spec(ts):
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in ts)


def _chunk(body, cond, consts, state, n):
    for _ in range(n):
        state = tuple(body(consts, state))
    return state, (cond(state) if cond is not None else None)


class _Entry(NamedTuple):
    """One captured chunk: its graph, static buffers and flag, and the
    kernel launches and collectives each replay makes."""

    graph: torch.cuda.CUDAGraph
    consts: tuple
    state: tuple
    flag: Optional[torch.Tensor]
    launches: dict
    collectives: Counter
    nbytes: int


def held() -> dict:
    """The captured chunks kept now (at most MAX_GRAPHS) and the sum of
    their capture bytes (``graph_bytes``)."""
    return {"graphs": len(_GRAPHS),
            "bytes": sum(e.nbytes for e in _GRAPHS.values())}


class _Loop:
    """One call of a loop: its chunks, replayed or run uncaptured."""

    def __init__(self, name, body, cond, consts, state, graph):
        self.name, self.body, self.cond = name, body, cond
        self.consts = tuple(consts)
        self.captured = (graph and not _MODE["eager"]
                         and all(t.is_cuda for t in (*self.consts, *state)))
        self.fn_key = (_fn_key(body), None if cond is None else _fn_key(cond))
        self.loaded: list = []      # entries holding this call's consts
        self.static = False         # the state lies in an entry's buffers

    def advance(self, state, n):
        """(state, flag) after n more rounds."""
        _count(self.name, rounds=n)
        if not self.captured:
            return _chunk(self.body, self.cond, self.consts, state, n)
        key = (self.name, n, self.fn_key, _spec(self.consts), _spec(state))
        entry = _GRAPHS.get(key)
        if entry is None:
            return self._capture(key, state, n)
        _GRAPHS.move_to_end(key)
        if not any(e is entry for e in self.loaded):
            for s, c in zip(entry.consts, self.consts):
                s.copy_(c)
            self.loaded.append(entry)
        if state is not entry.state:
            for s, x in zip(entry.state, state):
                s.copy_(x)
        entry.graph.replay()
        for k, v in entry.launches.items():
            LAUNCHES[k] += v
        if entry.collectives:
            from quatro_tpu_torch.parallel.diagnostics import ACTIVE
            for counts in ACTIVE:
                counts.update(entry.collectives)
        _count(self.name, replays=1)
        self.static = True
        return entry.state, entry.flag

    def _capture(self, key, state, n):
        """Run this chunk uncaptured on the capture stream (the warm-up;
        its result is the chunk's), then capture it for later calls."""
        dev = state[0].device
        cur = torch.cuda.current_stream(dev)
        side = _STREAMS.get(dev.index)
        if side is None:
            side = _STREAMS[dev.index] = torch.cuda.Stream(dev)
        if dev.index not in _POOLS:
            _POOLS[dev.index] = torch.cuda.graph_pool_handle()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out, flag = _chunk(self.body, self.cond, self.consts, state, n)
        consts = tuple(torch.empty_like(c) for c in self.consts)
        static = tuple(torch.empty_like(s) for s in state)
        buffers = sum(t.numel() * t.element_size()
                      for t in (*consts, *static))
        reserved = torch.cuda.memory_reserved(dev)
        from quatro_tpu_torch.parallel.diagnostics import (ACTIVE,
                                                           collective_profile)
        before = dict(LAUNCHES)
        profiles = [(c, c.copy()) for c in ACTIVE]
        graph = torch.cuda.CUDAGraph()

        def capture():
            got, g_flag = _chunk(self.body, self.cond, consts, static, n)
            for s, g in zip(static, got):
                s.copy_(g)
            return g_flag

        flags = []
        with torch.cuda.stream(side):
            # thread-local: a host sync in the body raises here, while
            # other threads (NCCL's watchdog) may go on using the card
            graph.capture_begin(pool=_POOLS[dev.index],
                                capture_error_mode="thread_local")
            try:
                collectives = collective_profile(
                    lambda: flags.append(capture()))
            finally:
                graph.capture_end()
        # nothing ran yet: the capture's launches and collectives are
        # counted at each replay instead
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                    if LAUNCHES[k] != before[k]}
        LAUNCHES.update(before)
        for counts, saved in profiles:
            counts.clear()
            counts.update(saved)
        cur.wait_stream(side)
        for t in (*out, *(() if flag is None else (flag,))):
            t.record_stream(cur)
        grew = buffers + torch.cuda.memory_reserved(dev) - reserved
        _GRAPHS[key] = _Entry(graph, consts, static, flags[0], launches,
                              collectives, grew)
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        _count(self.name, captures=1, graph_bytes=grew)
        CAPTURED["graphs"] += 1
        CAPTURED["bytes"] += grew
        self.static = False
        return out, flag

    def result(self, state):
        """The state, copied out of the static buffers it may lie in."""
        return tuple(t.clone() for t in state) if self.static else state


def _chunk_len(chunk: int) -> int:
    return max(1, _MODE["chunk"] or chunk)


def while_chunks(name: str, body: Callable, cond: Callable, consts, state,
                 bound: int, chunk: int, graph: bool = True):
    """``state = body(consts, state)`` while ``cond(state)`` (a 0-dim bool
    tensor on the state's device) holds, at most ``bound`` rounds;
    ``(state, trips)``. The flag is read before each chunk of
    ``min(chunk, bound - trips)`` rounds, so ``trips`` counts the rounds
    run, those past the exit included: ``body`` must leave a row that is
    no longer live as it is. ``graph=False``: the body cannot be captured
    (the caller says why)."""
    loop = _Loop(name, body, cond, consts, state, graph)
    chunk = _chunk_len(chunk)
    state = tuple(state)
    flag = cond(state)
    trips = 0
    while trips < bound:
        _count(name, reads=1)
        if not bool(flag):
            break
        n = min(chunk, bound - trips)
        state, flag = loop.advance(state, n)
        trips += n
    return loop.result(state), trips


def fori(name: str, body: Callable, consts, state, trips: int, chunk: int,
         graph: bool = True):
    """``state = body(consts, state)`` ``trips`` times, in chunks of
    ``chunk`` rounds, reading nothing back."""
    loop = _Loop(name, body, None, consts, state, graph)
    chunk = _chunk_len(chunk)
    state = tuple(state)
    done = 0
    while done < trips:
        n = min(chunk, trips - done)
        state, _ = loop.advance(state, n)
        done += n
    return loop.result(state)
