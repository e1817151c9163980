"""The trackers' compiled step: named static buffers and CUDA graphs.

The JAX trackers compile each filter step with ``jax.jit`` (the particle
step with its belief donated and ``dt`` traced, so that distinct frame
intervals do not retrace). A :class:`StepProgram` is the port's
counterpart. It owns

* **static buffers**, named, allocated at first use outside any capture:
  the belief, the frame, ``dt`` (a 0-d float32 tensor), the random
  numbers, and every tensor that one graph hands to the next or to the
  caller (:meth:`StepProgram.keep` copies a value into them);
* **the graphs**, one per key (``torch.cuda.CUDAGraph``). A key's first
  call runs its function eagerly on the program's side stream, and that
  run is the call's result; the capture that follows records the same
  work, and every later call replays it. All graphs of a program, and of
  the programs built to ``share`` it, are captured on one side stream
  and allocate from one memory pool (``pool_bytes``: what the captures
  added to the card's reserved memory). The stream is shared with the
  pool because the caching allocator reuses a freed block only on the
  stream that freed it;
* **the counters**: the launch counts of the port's kernel wrappers
  (``ops/kernels.py``, ``COUNTERS``) and whatever a program is given
  (``counters``: ``(object, attribute or key)``, such as a collective
  group's bytes sent). A replay runs no Python, so the program records
  each counter's change during a capture, takes it back (the capture
  launched nothing), and adds it on every replay.

A graph's function must return only kept tensors (anything else raises at
capture). So everything that crosses from one graph to another, or to the
host, lives in the named buffers, a graph's pool memory is only ever read
by that graph, and one pool is safe for graphs replayed one after another
in any order, whatever order they were captured in.

Python's cyclic garbage collector is off while a graph is recorded: a
collection then could free a dead program's graphs, and destroying a
graph while a stream captures invalidates the capture.

Without capture (the CPU, and ``capture=False`` on the card: the
counterpart of ``jax.disable_jit``) the same functions run eagerly through
the same buffers. ``capture=True`` on the CPU raises, and so does a
capture that fails: there is no quiet fallback to the eager step.

:func:`compiled` is the counterpart of ``jax.jit`` at a call site: one
function as the one graph of a program of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, Hashable, Optional

import torch

from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.utils.profiling import span

# (wrapper, attribute) of every launch counter a replay must keep: each
# wrapper's launches, the exchanges' too (a captured ``("exchange", b,
# path)`` graph launches ``age_pixel_rows``)
COUNTERS = tuple((w, "launches") for w in (
    *kernels.WRAPPERS.values(), *kernels.EXCHANGE_WRAPPERS.values())) + (
    (kernels.lineage_gather, "two_width_launches"),)


def resolve_capture(device, capture=None) -> bool:
    """Whether a step on ``device`` is captured: ``None`` means on a CUDA
    device; ``True`` on any other device raises."""
    device = torch.device(device)
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, got {device}: "
                         "CUDA graphs exist only on the card")
    return bool(capture)


_collector = {"captures": 0, "was_enabled": False}
_collector_lock = threading.Lock()


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector off for the block, and back as it was
    once no thread records a graph any more (captures in two threads
    overlap: a source's render and a tracker's step). What died meanwhile
    is collected after."""
    with _collector_lock:
        if _collector["captures"] == 0:
            _collector["was_enabled"] = gc.isenabled()
        _collector["captures"] += 1
        gc.disable()
    try:
        yield
    finally:
        with _collector_lock:
            _collector["captures"] -= 1
            if _collector["captures"] == 0 and _collector["was_enabled"]:
                gc.enable()


def _get(obj, key):
    return obj[key] if isinstance(obj, dict) else getattr(obj, key)


def _set(obj, key, value):
    if isinstance(obj, dict):
        obj[key] = value
    else:
        setattr(obj, key, value)


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    outputs: object
    deltas: list


class StepProgram:
    """Static buffers and the graphs of one step (see the module
    docstring). ``capture`` None means: on a CUDA ``device``. ``share``
    is another program whose capture stream and memory pool this one
    uses (its buffers stay its own). ``counters``: ``(object, attribute
    or key)`` pairs carried over replays beside the kernels' ``COUNTERS``
    (a dict's key, else an attribute)."""

    def __init__(self, device, capture=None,
                 share: Optional["StepProgram"] = None, counters=()):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capture = resolve_capture(self.device, capture)
        self.counters = tuple(COUNTERS) + tuple(counters)
        self._buffers: Dict[str, torch.Tensor] = {}
        self._graphs: Dict[Hashable, _Captured] = {}
        self._capturing = False
        self.pool = self.stream = None
        if self.capture and share is not None:
            self.pool, self.stream = share.pool, share.stream
        elif self.capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    @property
    def graph_count(self) -> int:
        return len(self._graphs)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    def buffer(self, name: str, shape, dtype=torch.float32):
        """The buffer ``name`` (allocated uninitialized at first use)."""
        buf = self._buffers.get(name)
        if buf is None:
            buf = self._allocate(name, tuple(shape), dtype)
        elif buf.shape != tuple(shape) or buf.dtype != dtype:
            raise ValueError(f"buffer {name!r} is {tuple(buf.shape)} "
                             f"{buf.dtype}, asked for {tuple(shape)} "
                             f"{dtype}")
        return buf

    def scalar(self, name: str, value):
        """The 0-d float32 buffer ``name`` set to ``value``: a number is a
        fill (no copy from the host), a tensor is copied."""
        buf = self.buffer(name, ())
        if isinstance(value, torch.Tensor):
            buf.copy_(value)
        else:
            buf.fill_(float(value))
        return buf

    def _allocate(self, name, shape, dtype):
        if self._capturing:
            raise RuntimeError(f"buffer {name!r} first seen during a "
                               "capture: a graph's work differs from its "
                               "eager first call")
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        self._buffers[name] = buf
        return buf

    def keep(self, name: str, value):
        """Copy ``value`` into the buffers named after ``name`` and return
        the same structure of buffers. ``value`` is a tensor or a tuple,
        list, dict, NamedTuple or dataclass of them (other leaves pass
        through: ``None``, numbers); a tensor that already is its buffer
        is not copied. Shapes and dtypes are fixed at first use."""
        if isinstance(value, torch.Tensor):
            buf = self.buffer(name, value.shape, value.dtype)
            if buf is not value:
                buf.copy_(value)
            return buf
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            return dataclasses.replace(value, **{
                f.name: self.keep(f"{name}.{f.name}", getattr(value, f.name))
                for f in dataclasses.fields(value)})
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            return type(value)(*(self.keep(f"{name}.{f}", v)
                                 for f, v in zip(value._fields, value)))
        if isinstance(value, (tuple, list)):
            return type(value)(self.keep(f"{name}.{i}", v)
                               for i, v in enumerate(value))
        if isinstance(value, dict):
            return {k: self.keep(f"{name}.{k}", v) for k, v in value.items()}
        return value

    def _check_kept(self, key, value):
        kept = {id(b) for b in self._buffers.values()}
        stack = [value]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                if id(x) not in kept:
                    raise RuntimeError(
                        f"graph {key!r} returns a tensor that is not a kept "
                        "buffer: another graph would overwrite it")
            elif dataclasses.is_dataclass(x) and not isinstance(x, type):
                stack.extend(getattr(x, f.name)
                             for f in dataclasses.fields(x))
            elif isinstance(x, (tuple, list)):
                stack.extend(x)
            elif isinstance(x, dict):
                stack.extend(x.values())

    def run(self, key: Hashable, fn: Callable[[], object]):
        """``fn()``, which reads and writes this program's buffers and
        returns kept ones: eagerly without capture; with capture, a replay
        of the graph of ``key`` (captured at its first call, whose eager
        run is that call's result). A running profiler records the host's
        side of it as the span ``dbot.step.run:<key's first element>``
        (``dbot.step.capture:...`` for a first call)."""
        name = key[0] if isinstance(key, tuple) else key
        if not self.capture:
            with span("dbot.step.run", name):
                return fn()
        done = self._graphs.get(key)
        if done is None:
            with span("dbot.step.capture", name):
                return self._first_call(key, fn)
        with span("dbot.step.run", name):
            done.graph.replay()
            for (obj, attr), d in zip(self.counters, done.deltas):
                if d:
                    _set(obj, attr, _get(obj, attr) + d)
        return done.outputs

    def _counts(self):
        return [_get(obj, name) for obj, name in self.counters]

    def _first_call(self, key, fn):
        home = torch.cuda.current_stream(self.device)
        # the eager run on the side stream brings up what a capture may
        # not do for the first time there (the kernel library, handles and
        # workspaces of the stream, cached constants)
        self.stream.wait_stream(home)
        with torch.cuda.stream(self.stream):
            out = fn()
        home.wait_stream(self.stream)
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = self._counts()
        graph = torch.cuda.CUDAGraph()
        self._capturing = True
        try:
            with _no_collection(), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                captured = fn()
        except Exception as e:
            raise RuntimeError(f"capturing the step's graph {key!r} failed "
                               f"on {self.device}: {e}") from e
        finally:
            self._capturing = False
            after = self._counts()
            for (obj, name), v in zip(self.counters, before):
                _set(obj, name, v)
        self._check_kept(key, captured)
        torch.cuda.synchronize(self.device)
        self.pool_bytes += max(
            0, torch.cuda.memory_reserved(self.device) - reserved)
        self._graphs[key] = _Captured(graph, captured,
                                      [a - b for a, b in zip(after, before)])
        self.capture_seconds += time.perf_counter() - t0
        return out

    def stats(self) -> dict:
        """Graphs, capture seconds and pool bytes (see the class)."""
        return {"graphs": self.graph_count,
                "capture_seconds": self.capture_seconds,
                "pool_bytes": self.pool_bytes,
                "buffer_bytes": sum(b.numel() * b.element_size()
                                    for b in self._buffers.values())}



def copy_out(x):
    """``x`` with every tensor in it copied (a tensor, or a tuple or a
    dataclass of tensors and None). A step returns its outputs other than
    the donated belief this way, out of the program's buffers, so that
    the next step does not overwrite what a caller kept: the reference
    donates only the belief. Called after the replay, on its stream: no
    host read."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(copy_out(v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: copy_out(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def compiled(fn: Callable, device, capture=None, donate: bool = False):
    """``fn`` as the one graph of a program of its own: the counterpart of
    ``jax.jit(fn)`` at a call site (``donate``: of ``donate_argnums=(0,)``
    for a step ``fn(state, *args) → (state', *outputs)``, whose ``state'``
    is written into the buffers of ``state``).

    Each call copies its arguments (tensors, or tuples, lists, dicts,
    NamedTuples and dataclasses of them; None passes) into the program's
    buffers, where a tensor is not its buffer already, and runs ``fn``
    through the program (:meth:`StepProgram.run`). The result is the
    program's buffers, overwritten by the next call. A number among the
    arguments would be frozen into the graph at its capture: pass it as
    a tensor. The program is the returned function's ``program``."""
    prog = StepProgram(device, capture)

    def call(*args):
        args = prog.keep("args", tuple(args))

        def body():
            out = fn(*args)
            if not donate:
                return prog.keep("out", out)
            return (prog.keep("args.0", out[0]),
                    *prog.keep("out", tuple(out[1:])))

        return prog.run("call", body)

    call.program = prog
    return call
