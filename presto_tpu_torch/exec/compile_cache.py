"""Compiled mode's executables: one CUDA graph per query.

Reference: presto_tpu/exec/compile_cache.py, where a compiled query is
one jitted XLA program.  Here the static executor
(`exec/executor.py`, `Executor(static=True)`) is eager PyTorch that
reads nothing back to the host before its packed fetch, so on a CUDA
device `build_graph` runs it once and captures it as a
`torch.cuda.CUDAGraph`, which every later run of the query replays: one
replay in place of the hundreds of launches of an eager run.  On the
CPU nothing is captured and the executable runs the static executor
eagerly, so the CPU tests run the very code that the card captures.

Telemetry: every build counts in the recording QueryStats' `compiles`
and `compile_ms` (on a CUDA device the eager pass and the capture), and
a query whose executable came from the session's memo counts one
`compile_cache_hits`.

The session's memo (`GraphMemo`) is bounded: each graph keeps a private
memory pool of its query's intermediates, so the memo holds at most
`compiled_cache_max_bytes` of them (and MEMO_MAX_ENTRIES entries) and
evicts the least recently used, whose pools go back to the device.  Not ported: the reference's persistent disk cache,
compile-ahead, and its process-wide memo keyed on plan serde bytes (it
waits for plan/serde.py).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Optional

import torch

from presto_tpu_torch.batch import UploadLog, logged_uploads

#: compiled_cache_max_bytes of 0: this share of the device's memory (on
#: the CPU, of _CPU_MEMO_BYTES)
_MEMO_DEVICE_SHARE = 4
_CPU_MEMO_BYTES = 1 << 30
#: entries a session memo holds at most, whatever they weigh ("DYNAMIC"
#: markers weigh nothing)
MEMO_MAX_ENTRIES = 256

_tls = threading.local()


def note(field: str, amount=1) -> None:
    """Add to a counter of the recording QueryStats, if any."""
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        setattr(sink, field, getattr(sink, field, 0) + amount)


@contextmanager
def recording(stats):
    """Route this thread's compile accounting into `stats` (a
    QueryStats); nests."""
    prev = getattr(_tls, "sink", None)
    _tls.sink = stats
    try:
        yield stats
    finally:
        _tls.sink = prev


class Executable:
    """One compiled query.  Calling it runs the query once and returns
    the static executor's (outputs, guard) as device tensors: on a CUDA
    device by replaying the captured graph (the outputs are the graph's
    own and are overwritten by the next replay), on the CPU by running
    the static executor.  A build whose eager pass tripped a guard holds
    that pass's outputs and no graph.

    For the record: `eager_ms` and `capture_ms` of the build, the bytes
    `pool_bytes` the graph's private memory pool reserved and the number
    of `replays`."""

    def __init__(self, fn=None, example=(), graph=None, outputs=None,
                 keep=None):
        self.fn = fn
        self.example = example
        self.graph = graph
        self.outputs = outputs
        self.keep = keep  # what the graph reads beside the example
        self.eager_ms = 0.0
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            return self.outputs
        if self.fn is not None:
            return self.fn(*self.example)
        return self.outputs

    def release(self) -> None:
        """Drop the graph, its outputs and what it reads: its private
        pool's blocks go back to the device at the next
        torch.cuda.empty_cache()."""
        self.outputs = None
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.fn = self.keep = None
        self.example = ()


def memo_bound(session) -> int:
    """The byte bound of the session's memo: compiled_cache_max_bytes,
    or for 0 a quarter of the device's memory (1 GiB on the CPU)."""
    bound = int(session.properties.get("compiled_cache_max_bytes", 0))
    if bound > 0:
        return bound
    if session.device.type == "cuda":
        total = torch.cuda.get_device_properties(session.device).total_memory
        return total // _MEMO_DEVICE_SHARE
    return _CPU_MEMO_BYTES


class GraphMemo:
    """A session's compiled queries by query_cache_key, least recently
    used first.  An entry weighs the bytes that it alone holds on the
    device (its graph's pool, its scan selections and uploads); a
    "DYNAMIC" marker weighs nothing.  Storing an entry evicts the least
    recently used others until the memo is within `max_bytes` and
    `max_entries` (the newest always stays), and releases the evicted
    executables (`Executable.release`), whose pools then go back to the
    device."""

    def __init__(self, max_bytes: int, max_entries: int):
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self.evictions = 0
        # key -> (entry, bytes, its executable or None)
        self._entries: OrderedDict = OrderedDict()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __getitem__(self, key):
        return self._entries[key][0]

    def values(self):
        return [entry for entry, _, _ in self._entries.values()]

    @property
    def nbytes(self) -> int:
        return sum(n for _, n, _ in self._entries.values())

    def get(self, key):
        """The entry under `key`, now the most recently used, or None."""
        if key not in self._entries:
            return None
        self._entries.move_to_end(key)
        return self._entries[key][0]

    def put(self, key, entry, nbytes: int = 0,
            exe: Optional[Executable] = None) -> None:
        """Store `entry` (holding `exe`, if any) as the most recently
        used, then evict down to the bounds."""
        old = self._entries.pop(key, None)
        self._entries[key] = (entry, nbytes, exe)
        if old is not None and old[2] is not None and old[2] is not exe:
            old[2].release()
        released = False
        while len(self._entries) > 1 and (
                self.nbytes > self.max_bytes
                or len(self._entries) > self.max_entries):
            _, (_, _, dropped) = self._entries.popitem(last=False)
            self.evictions += 1
            if dropped is not None:
                dropped.release()
                released = dropped.pool_bytes > 0 or released
        if released:
            torch.cuda.empty_cache()


def build_graph(fn: Callable, example: tuple,
                device: Optional[torch.device] = None) -> Executable:
    """Build the executable of `fn(*example)`, which must return
    (outputs, guard): device tensors and a 0-d device bool that is true
    when a static assumption failed.

    On a CUDA device it
    1. runs fn once on a side stream with torch's sync debug mode set to
       "error", so that a host read raises at its own line (capture
       would fail on it less clearly), its uploads logged
       (batch.upload);
    2. reads that run's guard; only if it is clear,
    3. captures fn under torch.cuda.graph into a private memory pool,
       uploads served from the log.
    On the CPU it returns fn itself, run at each call."""
    t0 = time.perf_counter()
    if device is None or device.type != "cuda":
        note("compiles")
        note("compile_ms", (time.perf_counter() - t0) * 1e3)
        return Executable(fn, example)
    log = UploadLog()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    debug = torch.cuda.get_sync_debug_mode()
    with torch.cuda.stream(side), logged_uploads(log):
        torch.cuda.set_sync_debug_mode("error")
        try:
            outputs = fn(*example)
        finally:
            torch.cuda.set_sync_debug_mode(debug)
    torch.cuda.current_stream(device).wait_stream(side)
    tripped = bool(outputs[1])
    eager_ms = (time.perf_counter() - t0) * 1e3
    if tripped:
        exe = Executable(outputs=outputs, keep=log)
        exe.eager_ms = eager_ms
        note("compiles")
        note("compile_ms", eager_ms)
        return exe
    del outputs
    t1 = time.perf_counter()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()  # the eager pass's blocks
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    log.capturing = True
    with logged_uploads(log), torch.cuda.graph(graph):
        outputs = fn(*example)
    torch.cuda.synchronize(device)
    exe = Executable(example=example, graph=graph, outputs=outputs, keep=log)
    exe.eager_ms = eager_ms
    exe.capture_ms = (time.perf_counter() - t1) * 1e3
    exe.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    note("compiles")
    note("compile_ms", eager_ms + exe.capture_ms)
    return exe
