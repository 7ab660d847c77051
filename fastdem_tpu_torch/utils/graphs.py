"""The port's counterpart of ``jax.jit(fn, donate_argnums=(0,))``: a step
captured into a CUDA graph once per input signature, then replayed.

``jit(fn, donate=True)`` returns a callable with ``fn``'s signature. Its
arguments are tensors and pytrees of them: dataclasses (``GridMapState``,
``IntegrateAux``), dicts, tuples, lists; ``None`` and other Python values
are constants of the signature, and so is an object whose class sets
``graph_constant = True`` (a hashable value such as
``parallel.sharding.BlockMesh``: it is kept as it is, never walked).

On CUDA tensors:

* The signature is the pytree structure with its constants (which optional
  channels are None, an ``spmd_blocks`` step's ``block=``), and every
  tensor's shape, dtype and device. Each has its own graph.
* The first call of a signature allocates one slot per input tensor,
  copies the inputs in, runs ``fn`` once on the slots on a side stream
  (the warm-up: it loads the kernels, sets their attributes and fills the
  caching allocator; its result is dropped), captures ``fn`` on the slots
  into a ``torch.cuda.CUDAGraph``, and replays it once: the first call's
  result is exactly one step.
* ``fn`` may write its first argument in place: it runs on the slots,
  never on the caller's tensors. The warm-up's writes land in the slots,
  and the first replay fills those slots again from the caller's inputs,
  since a first call's inputs are never the slots.
* A later call copies each input into its slot (not one the caller passed
  as the slot itself) and replays. A donating step counts its calls whose
  donated argument came in as its slots (``step.state_in_place``) and those
  that copied it in (``step.state_copied_in``, the first call of each
  signature among them), and marks each call's ``step.copy_in`` span with
  ``STATE_IN_PLACE`` or ``STATE_COPIED_IN`` in its ``attr``.
* ``donate``: the first output (the whole output when it is not a tuple)
  has the structure of the first argument, and the graph writes it into
  that argument's slots, so the returned state IS the slots and the next
  call that passes it back copies nothing. An output leaf that ``fn``
  wrote in place is its slot already and is not copied; each graph counts
  the others at its capture (``GraphStats.slot_copies_per_replay``). As in
  JAX, the state passed in is consumed: a caller that passes the slots
  must not expect them to keep their old values. Without ``donate`` that
  output is cloned. ``CompiledStep.holds(tree)`` tells whether ``tree`` is
  such slots.
* Every other output is cloned after the replay, so a value the caller
  holds never changes under a later call (JAX returns fresh arrays).
* A capture that fails raises, naming the signature; nothing falls back to
  eager. ``fn`` must not read the device from the host (``.item()``, a
  data-dependent shape) nor copy from host memory (``torch.tensor`` of
  host data) inside its body.

On the CPU ``fn`` runs as it is, on a copy of its first argument: the plain
path, as for the kernels' twins (``plain(fn)`` is that path on any device).

Every call of one step must enqueue on one stream (the node's threads all
use the default stream): the graphs share their temporaries (see Memory).

Captures run on a fresh non-blocking stream in the ``thread_local`` error
mode: work that other threads put on the default stream meanwhile does not
join the capture. The node (``runtime.driver``) still captures under its
lock, where no other of its threads runs device work but the host reads.

Kernel launch counters: a module whose kernel wrapper counts its
launches in a module-level ``launches`` registers itself with
``count_launches`` (the hand-written kernels' wrappers in ``ops`` do). A
replay makes no Python call, so each graph records how many launches its
capture made and adds them to the registered counters on every replay.
Neither the warm-up's nor the capture's calls stay counted: the counters
tell how often a kernel ran for a result.

Memory: the graphs of one ``CompiledStep`` share one memory pool. Their
replays are serialised by the step's lock and enqueued in call order, and
no graph's outputs are read after another graph's replay (they are
cloned, or written into the slots, which lie outside the pool), so a
later capture may reuse what an earlier one freed. The pool holds each
graph's outputs and the largest graph's temporaries; the slots are
outside it. The number of graphs is the number of signatures the caller
passes: the facade (``mapping.pipeline.FastDEM``) bounds it by padding
each scan to a power of two. A step made for one call (registration's
fused driver) takes its graphs and pool with it when it is dropped. Each
capture first returns the blocks the caching allocator keeps to the
device (``empty_cache``): those it keeps for eager work and those of
dropped pools. The new pool cannot use them, and a capture cannot free
them.

``jit(fn, warm=False)`` skips the warm-up, for a caller that has just run
``fn`` eagerly on the same device (the kernels are loaded, the library
handles made): its first call captures and replays, with no run whose
result is dropped.

Spans (``utils/tracing.py``): ``step.call`` around every call, with
``step.copy_in``, ``step.launch`` and ``step.clone_out`` inside a replay and
``step.capture`` around a first call (counted in ``step.captures``); on the
card ``step.device`` from the end of the enqueue to the work's completion
on the device, and a reading of the allocator's device allocations every
``tracing.ALLOC_EVERY`` calls. A replay's ``step.launch`` carries
``SLOT_COPIES`` and the graph's donated outputs copied into their slots
in its ``attr``. Each graph's ``GraphStats.replays`` is the counter
``graphs.replays``, its ``GraphStats.slot_copies`` the counter
``step.slot_copies``, K1's and K4's ``launches`` the counters
``polar_field.launches`` and ``resample.launches``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Tuple

import torch

from fastdem_tpu_torch.utils import tracing

_LEAF = "tensor"

_CALL = tracing.name_id("step.call")
_COPY_IN = tracing.name_id("step.copy_in")
_LAUNCH = tracing.name_id("step.launch")
_CLONE_OUT = tracing.name_id("step.clone_out")
_CAPTURE = tracing.name_id("step.capture")
_DEVICE = tracing.name_id("step.device")

# The ``attr`` of a donating step's ``step.copy_in`` span: its donated
# argument came in as the graph's slots, or was copied into them.
STATE_IN_PLACE = 1
STATE_COPIED_IN = 2
# The ``attr`` of a replay's ``step.launch`` span: this bit, and below it
# the number of donated outputs the graph copies into their slots.
SLOT_COPIES = 1 << 32

# Modules whose ``launches`` counter the graphs keep (``count_launches``).
_COUNTED: List[Any] = []


def count_launches(module) -> None:
    """Keep ``module.launches`` (an int its kernel wrapper adds one to per
    launch) true through the replays of every graph; it is the counter
    ``<module>.launches`` of ``tracing.counters()``."""
    if module not in _COUNTED:
        _COUNTED.append(module)
        tracing.register(module.__name__.rsplit(".", 1)[-1] + ".launches", module, "launches")


@contextlib.contextmanager
def _counters_kept():
    """Every registered counter as it was before the block, after it."""
    before = [(m, m.launches) for m in _COUNTED]
    try:
        yield
    finally:
        for m, n in before:
            m.launches = n


def _walk(x, leaves: List[torch.Tensor]):
    """The structure of ``x``, its tensors appended to ``leaves``. Not a
    closure calling itself: that is a cycle, holding every tensor it saw."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _LEAF
    if getattr(x, "graph_constant", False):
        hash(x)
        return ("const", x)
    if isinstance(x, tuple):
        return ("tuple", tuple(_walk(v, leaves) for v in x))
    if isinstance(x, list):
        return ("list", tuple(_walk(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _walk(v, leaves)) for k, v in x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dataclass", type(x),
                tuple((f.name, _walk(getattr(x, f.name), leaves))
                      for f in dataclasses.fields(x)))
    hash(x)  # a constant of the signature must be hashable
    return ("const", x)


def _flatten(tree) -> Tuple[Any, List[torch.Tensor]]:
    """(structure, tensor leaves) of a pytree; the structure is hashable
    and holds every non-tensor value."""
    leaves: List[torch.Tensor] = []
    return _walk(tree, leaves), leaves


def _unflatten(spec, leaves) -> Any:
    """The pytree of ``spec`` with its tensors taken from ``leaves`` (a
    list, or an iterator the recursion shares) in order."""
    it = iter(leaves)
    if spec == _LEAF:
        return next(it)
    kind = spec[0]
    if kind == "tuple":
        return tuple(_unflatten(v, it) for v in spec[1])
    if kind == "list":
        return [_unflatten(v, it) for v in spec[1]]
    if kind == "dict":
        return {k: _unflatten(v, it) for k, v in spec[1]}
    if kind == "dataclass":
        return spec[1](**{name: _unflatten(v, it) for name, v in spec[2]})
    return spec[1]


@dataclasses.dataclass
class GraphStats:
    """What one signature's graph cost."""

    capture_seconds: float  # the first call: slots, warm-up, capture, replay
    pool_bytes: int  # device memory its capture added to the step's pool
    slot_bytes: int  # the input slots
    launches_per_replay: Dict[str, int]  # by counting module
    slot_copies_per_replay: int  # donated outputs copied into their slots
    replays: int = 0
    slot_copies: int = 0  # over the replays


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class CudaGraphs:
    """The capture primitive: ``torch.cuda.CUDAGraph`` on a side stream."""

    @staticmethod
    def applies(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def synchronize(device: torch.device) -> None:
        torch.cuda.synchronize(device)

    @staticmethod
    def new_pool(device: torch.device):
        """A memory pool for the graphs of one step."""
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(device: torch.device, warm, body, pool):
        """Run ``warm()``, then capture ``body()`` into a graph allocating
        from ``pool``; returns the graph (``replay()`` reruns what ``body``
        enqueued), ``body``'s result and the bytes the capture added to the
        pool."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            warm()
            side.synchronize()
            # The capture allocates from its own pool, which cannot take the
            # blocks the allocator caches for eager work (the warm-up's among
            # them) or holds for dropped pools, nor free them while it
            # captures: return them first.
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(device)
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid already; the caller reports the cause
                raise
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        return graph, out, torch.cuda.memory_reserved(device) - reserved0


# The capture primitive every CompiledStep uses (a test may replace it).
BACKEND = CudaGraphs()


class _Graph:
    """One signature's slots, graph and outputs. The first call replays it
    right after the capture, copying the inputs into the slots again, so
    the call is one step whatever the capture primitive ran meanwhile."""

    def __init__(self, fn, spec, leaves, spec0, n_donated, donate, warm, label, pool):
        dev = leaves[0].device
        self.slots = [torch.empty_like(t, memory_format=torch.contiguous_format)
                      for t in leaves]
        for s, t in zip(self.slots, leaves):
            s.copy_(t)
        args, kwargs = _unflatten(spec, self.slots)
        self.per_replay: Dict[Any, int] = {}

        def body():
            before = {m: m.launches for m in _COUNTED}
            outs = self._bind_outputs(fn(*args, **kwargs), spec0, n_donated, donate, label)
            self.per_replay = {m: m.launches - n for m, n in before.items()}
            return outs

        warmed = []

        def warm_up():
            if warm:
                fn(*args, **kwargs)  # its result is dropped
            warmed.append(True)

        try:
            with _counters_kept():
                self.graph, self.outs, pool_bytes = BACKEND.capture(dev, warm_up, body, pool)
        except BaseException as err:
            if not warmed:
                raise  # ``fn`` itself failed, as it would eagerly
            raise RuntimeError(
                f"CUDA graph capture of {label} failed for the signature "
                f"{_describe(leaves)}: {type(err).__name__}: {err}"
            ) from err
        self.stats = GraphStats(
            capture_seconds=0.0,
            pool_bytes=pool_bytes,
            slot_bytes=sum(s.numel() * s.element_size() for s in self.slots),
            launches_per_replay={m.__name__: n for m, n in self.per_replay.items()},
            slot_copies_per_replay=self.slot_copies,
        )
        tracing.register("graphs.replays", self.stats, "replays")
        tracing.register("step.slot_copies", self.stats, "slot_copies")

    def _bind_outputs(self, out, spec0, n_donated, donate, label):
        """Inside the capture: write the donated output into its slots
        (a leaf ``fn`` wrote in place is its slot already), and keep every
        other output apart from the input slots (one sharing memory with an
        input slot is cloned before the donated output is copied in).
        Returns the graph's outputs, flattened."""
        self.out_spec, outs = _flatten(out)
        dslots = self.slots[:n_donated] if donate else []
        if donate:
            head = out[0] if isinstance(out, tuple) else out
            head_spec, head_leaves = _flatten(head)
            if head_spec != spec0 or any(
                o.shape != s.shape or o.dtype != s.dtype for o, s in zip(head_leaves, dslots)
            ):
                raise ValueError(
                    f"{label}: donate=True needs the first output shaped as the first "
                    "argument"
                )
        slot_ptrs = {s.untyped_storage().data_ptr() for s in self.slots}
        # The donated output's leaves lead the flattened output; one that
        # is its own slot stays as it is.
        outs = [
            o if i < len(dslots) and _same_memory(o, dslots[i])
            else o.clone() if o.untyped_storage().data_ptr() in slot_ptrs else o
            for i, o in enumerate(outs)
        ]
        copied = [(s, o) for s, o in zip(dslots, outs) if not _same_memory(s, o)]
        for s, o in copied:
            s.copy_(o)
        self.slot_copies = len(copied)
        self.donated = len(dslots)
        return dslots + outs[len(dslots):]

    def replay(self, leaves):
        """Copy the inputs into the slots, replay, and return the outputs
        (the donated ones as the slots, the others cloned)."""
        sp = tracing.begin(_COPY_IN)
        if self.donated:
            in_place = all(_same_memory(s, t) for s, t in
                           zip(self.slots[: self.donated], leaves[: self.donated]))
            tracing.count("step.state_in_place" if in_place else "step.state_copied_in")
            tracing.tag(sp, STATE_IN_PLACE if in_place else STATE_COPIED_IN)
        for s, t in zip(self.slots, leaves):
            if not _same_memory(s, t):
                s.copy_(t)
        tracing.end(sp)
        sp = tracing.begin(_LAUNCH)
        tracing.tag(sp, SLOT_COPIES | self.slot_copies)
        self.graph.replay()
        tracing.end(sp)
        self.stats.replays += 1
        self.stats.slot_copies += self.slot_copies
        for m, n in self.per_replay.items():
            m.launches += n
        sp = tracing.begin(_CLONE_OUT)
        outs = self.outs[: self.donated] + [o.clone() for o in self.outs[self.donated:]]
        out = _unflatten(self.out_spec, outs)
        tracing.end(sp)
        return out


def _describe(leaves) -> str:
    """A readable signature: the tensors' shapes and dtypes in order."""
    shapes = ", ".join(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}" for t in leaves)
    return f"({shapes}) on {leaves[0].device if leaves else 'no device'}"


class CompiledStep:
    """``fn`` captured per signature (see the module docstring)."""

    def __init__(self, fn, donate: bool = True, warm: bool = True):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.donate = donate
        self.warm = warm
        self.name = getattr(fn, "__qualname__", repr(fn))
        self.graphs: Dict[Any, _Graph] = {}
        self._pool = None  # the graphs' shared memory pool, made at the first capture
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        sp = tracing.begin(_CALL)
        try:
            return self._call(args, kwargs)
        finally:
            tracing.end(sp)

    def _call(self, args, kwargs):
        # One walk, the first argument's leaves first: ``_flatten((args, kwargs))``.
        leaves: List[torch.Tensor] = []
        head = tuple(_walk(a, leaves) for a in args[:1])
        n_donated = len(leaves)
        spec = ("tuple", (("tuple", head + tuple(_walk(a, leaves) for a in args[1:])),
                          _walk(kwargs, leaves)))
        dev = leaves[0].device if leaves else None
        if dev is None or not BACKEND.applies(dev):
            return self.fn(*_first_copied(args), **kwargs)
        if any(t.device != dev for t in leaves):
            raise ValueError(f"{self.name}: every tensor must be on {dev}")
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
        with self._lock:
            graph = self.graphs.get(key)
            if graph is not None:
                out = graph.replay(leaves)
            else:
                out = self._capture(key, spec, leaves, head[0] if head else None,
                                    n_donated, dev)
            if dev.type == "cuda":
                tracing.device_span(_DEVICE, dev)
                tracing.sample_allocs(dev)
            return out

    def _capture(self, key, spec, leaves, spec0, n_donated, dev):
        """The first call of a signature: capture, replay once, keep."""
        t0 = time.perf_counter()
        sp = tracing.begin(_CAPTURE)
        tracing.count("step.captures")
        if self._pool is None:
            self._pool = BACKEND.new_pool(dev)
        try:
            # The first argument's leaves lead ``leaves``.
            graph = _Graph(self.fn, spec, leaves, spec0, n_donated, self.donate,
                           self.warm, self.name, self._pool)
        except BaseException:
            self._pool = None  # later captures start a pool of their own
            raise
        out = graph.replay(leaves)
        BACKEND.synchronize(dev)
        tracing.end(sp)
        graph.stats.capture_seconds = time.perf_counter() - t0
        self.graphs[key] = graph
        return out

    def holds(self, tree) -> bool:
        """Whether ``tree``'s tensors are one graph's donated slots, i.e.
        the state a donating call returned for that signature."""
        _, leaves = _flatten(tree)
        return any(
            g.donated == len(leaves)
            and all(_same_memory(s, t) for s, t in zip(g.slots, leaves))
            for g in self.graphs.values()
        )

    def stats(self) -> List[GraphStats]:
        """One entry per captured signature, in capture order."""
        return [g.stats for g in self.graphs.values()]

    def clear(self) -> None:
        """Drop every graph (their slots and pool go with them)."""
        with self._lock:
            self.graphs.clear()
            self._pool = None


def _first_copied(args: tuple) -> tuple:
    """``args`` with the first argument's tensors cloned, for an ``fn`` that
    may write it in place: the caller's own tensors never change."""
    if not args:
        return args
    spec, leaves = _flatten(args[0])
    return (_unflatten(spec, [t.clone() for t in leaves]),) + tuple(args[1:])


def plain(fn):
    """``fn`` run as it is, on a copy of its first argument (which ``fn``
    may write in place), as ``jit(fn)`` runs on the CPU: the eager step.
    ``.fn`` is ``fn`` itself, for a caller that owns what it passes."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        return fn(*_first_copied(args), **kwargs)

    run.fn = fn
    return run


def jit(fn, donate: bool = True, warm: bool = True) -> CompiledStep:
    """``fn`` captured into a CUDA graph per input signature, with the first
    argument donated (see the module docstring)."""
    return CompiledStep(fn, donate=donate, warm=warm)
