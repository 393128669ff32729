"""Captured programs: the port's stand-in for the JAX package's `jax.jit`
programs under `functools.lru_cache`.

The JAX package never runs a serving path op by op: each serving core is
one jitted program per static configuration (the lru_cache key) and input
shape, and the shape buckets keep that set finite.  On a CUDA card the
counterpart is a CUDA graph: the body is captured once per static key and
input shapes and dtypes, then replayed with one launch, so that the host
issues one call where it issued thousands of kernel launches.

A `ProgramCache` holds the programs of one kind (the Euler sampler, the
codec's encode, its decode, the bench's stages, the train and distill
steps), least recently used first, up to its bound.  Each program
belongs to an owner, the object whose tensors its graph reads (the DiT,
the codec, a train state), or to a tuple of owners (a distill step reads
its student's train state and its frozen teacher in place: copying the
teacher's weights into static buffers would double them).  The cache
keeps only weak references to them, and a program any of whose owners
has been freed is never replayed and is dropped before the next program
call (`purge`, which a caller may also run itself, so that a freed
owner's graph and its pool memory go before other work), with its graph
and its memory.  The body receives the owner (or the tuple) as its first
argument and must hold no other reference to it.

A call, `cache(key, owner, inputs, make_body)`:

  * looks the program up by (key, the owners' identities, the structure
    and the shapes, dtypes and devices of the input tensors);
  * on a miss, copies the inputs into static buffers ("Static inputs"
    below), calls `make_body()` once (the per-key constants are built
    there) and runs the body eagerly on the buffers.  That run is the
    warm-up PyTorch asks for before a capture (the kernels are built, their
    shared-memory attributes set, every cached table the body reads is
    made) and its result answers the call.  Then, on a card, the body is
    captured with `torch.cuda.graph` into one memory pool that every
    program of the process shares; capture runs no kernel;
  * on a hit, copies the inputs into the static buffers with `copy_`,
    replays the graph and returns a clone of the static output: the next
    replay overwrites the static output, and a caller may still hold it
    (run_batch slices the sampler's latents for its decodes).  The miss
    run's result is cloned too, since a body may return a buffer it
    wrote in place (the streams' carried state and prefix).

On the CPU the same plumbing runs (static buffers, copy in, clone out),
but the body is called directly, because there is nothing to capture; so
the CPU tests run everything but the capture.  There is no switch that
turns capture off: a capture that fails raises, and nothing falls back to
the eager body.  The fix for a body that cannot be captured (a `.item()`,
`bool(tensor)`, `.cpu()` or a pageable host copy inside it: anything that
makes the host wait on the card) is in the body.

Two things the kernels' wrappers do on the host need the program's help:

  * launch counts.  A wrapper counts a launch when Python calls it; a
    replay calls no Python.  Each counter registered with
    `register_counters` is read before and after the capture, set back
    (the capture launched nothing), and the difference is added on every
    replay, so the counts stay exact;
  * tensors made outside the graph that the graph reads (the RoPE and
    timestep tables, the residual stacks' kernel-layout weights), which
    live in caches that can drop them.  Their makers pass them through
    `hold`, and the program being built keeps a reference to each.

Static inputs.  The programs of one cache share their static input
buffers by (input slot, shape, dtype, device): every stream block
program of a total bucket reads its text and speaker K/V (151 MB at the
published width), its prefix and its carried latent K/V from the same
buffers, not from a copy each.  Sharing is safe because every call copies
all of its inputs into the buffers before its replay, under the lock
below, and clones its output before the next call; a body that writes
into one of its inputs (the latent prefix, the carried latent K/V) must
return it, so that the clone carries the write out.  `static_bytes`
reports what the buffers hold, beside `pool_bytes`.  A carried state is
copied in and cloned out at each call (there is no counterpart of JAX's
buffer donation): at the 5120-latent bucket about 344 MB each way.

Bodies that update their owner.  A train step's body runs the loss, its
backward, the clip, AdamW and the EMA, and writes the owner's tensors in
place: the parameters, their `.grad` (zeroed, not freed, and accumulated
into in place), AdamW's moments and step counts (made by the eager miss
run, before the capture) and its learning-rate tensor, and the EMA.  A
graph holds the addresses it was captured with, so no tensor that a live
train program reads may be re-allocated: whatever does so (loading an
optimizer state dict, `.to()`, `requires_grad_`, setting `.grad` to
None) must drop the program first (`ProgramCache.clear`).  A capture
runs no kernel, so the miss applies one update (its eager run) and each
replay one more.  The temporaries of such a body, the saved activations
and the backward's buffers, come from the shared pool like every other
program's: safe, since no two programs replay at once (below).

Scoped programs.  A body may depend on more than its owners: the mesh
cores (the Euler sampler, the train and distill steps and the
sequence-parallel speaker prefill under a (data, model) mesh) run
collectives whose communicators their graphs record.  Such a call passes
a `scope`, an object this module treats as opaque but for two members:
`scope.key`, hashable, which joins the program's key, and
`scope.check(device)`, called before a miss runs anything, which raises
to refuse the program (it does not ask for an eager run instead).  The
program keeps its scope alive.  `drop_scoped` drops every program made
with a scope, with its graph, at once; whatever the scopes stand for
decides when (parallel/mesh.py, "Programs over a mesh": before the
process group goes).  Two rules hold for any body that runs collectives:

  * in a process that has joined a process group the capture runs in
    CUDA's "thread_local" mode, not PyTorch's default "global".
    ProcessGroupNCCL's watchdog thread polls the events of earlier
    collectives (the miss run's among them) with cudaEventQuery, and
    under "global" such a call from any thread during a capture
    invalidates it ("operation not permitted when stream is capturing").
    Letting the miss run's work complete first is not enough, since the
    watchdog polls a completed event until it has seen it (torch.cuda.
    graph synchronises on entry all the same).  "thread_local" forbids
    unsafe calls on the capturing thread alone, which issues only the
    body's work;
  * ranks stay in step: every rank makes the same calls, so it misses,
    captures and replays the same programs in the same order.  A rank
    whose program is gone (the LRU bound, a freed owner) while a peer's
    lives cannot leave the peer waiting: its miss runs the body eagerly,
    which issues every collective of the body once, in the body's
    order, as the peer's replay does, and its capture issues none (a
    capture launches nothing).  Either way a call issues each collective
    once, in one order.  The eager run on a miss is also the
    communicators' warm-up: it creates each before any capture.

Concurrency.  All programs share one memory pool, so two of them must
never replay at the same time: one replay's temporaries are another's.
Every call runs under one process-wide lock, on the calling thread's
current stream (PyTorch's default stream unless a caller set another),
so calls and their replays queue in one order.  The micro-batching
server already serialises its device work (serve/server.py,
MicroBatchServer.device_lock), and the handler's streams hold the same
lock.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

_COUNTERS: List[Tuple[object, str]] = []   # the kernel wrappers' launch counts
_CACHES: List["ProgramCache"] = []
_POOLS: Dict[int, list] = {}   # device index -> [pool handle, live graphs]
_LOCK = threading.RLock()
_LOCAL = threading.local()                  # .held: the programs being built
CAPTURES: List[Tuple[str, float]] = []      # (cache name, capture seconds)


def register_counters(owner: object, *attrs: str) -> None:
    """Make `owner.<attr>` (a kernel wrapper's launch count) exact under
    replay: a capture's launches are taken back and added on each replay."""
    for attr in attrs:
        if (owner, attr) not in _COUNTERS:
            _COUNTERS.append((owner, attr))


def hold(obj):
    """Return obj; a program being built (its eager run or its capture)
    keeps a reference to it, because its graph may read it."""
    stack = getattr(_LOCAL, "held", None)
    if stack:
        stack[-1][id(obj)] = obj
    return obj


@contextlib.contextmanager
def _holding(held: dict):
    stack = getattr(_LOCAL, "held", None)
    if stack is None:
        stack = _LOCAL.held = []
    stack.append(held)
    try:
        yield
    finally:
        stack.pop()


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _pool(device: torch.device) -> list:
    """[handle, live graphs] of the device's shared pool.  The caching
    allocator retires a pool with its last graph and refuses its handle
    after that, so a pool whose graphs are all gone is replaced."""
    idx = _device_index(device)
    if idx not in _POOLS:
        with torch.cuda.device(idx):
            _POOLS[idx] = [torch.cuda.graph_pool_handle(), 0]
    return _POOLS[idx]


def _graph_freed(idx: int, pool: list) -> None:
    pool[1] -= 1
    if pool[1] == 0 and _POOLS.get(idx) is pool:
        del _POOLS[idx]


# ---------------------------------------------------------------------------
# input and output trees: tensors (or None) in tuples, named tuples, lists
# and dicts
# ---------------------------------------------------------------------------

def _flatten(tree, leaves: list):
    """A hashable description of tree's structure; its tensors appended to
    leaves in order."""
    if tree is None or isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        keys = tuple(tree)
        return ("dict", keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (tuple, list)):
        kind = type(tree) if hasattr(tree, "_fields") else type(tree).__name__
        return (kind, tuple(_flatten(x, leaves) for x in tree))
    raise TypeError(f"a program's inputs and outputs are tensors in tuples, "
                    f"lists and dicts; got {type(tree).__name__}")


def _build(spec, it):
    # a module-level recursion: a nested one would be a reference cycle
    # (the function in its own closure, with the leaves' iterator) that
    # keeps every leaf alive until the garbage collector runs, hundreds of
    # MB a call for a stream's carried state
    if spec is None:
        return next(it)
    if spec[0] == "dict":
        return {k: _build(c, it) for k, c in zip(spec[1], spec[2])}
    items = [_build(c, it) for c in spec[1]]
    if spec[0] == "list":
        return items
    if spec[0] == "tuple":
        return tuple(items)
    return spec[0](*items)                  # a named tuple


def _unflatten(spec, leaves):
    return _build(spec, iter(leaves))


def _clone_tree(tree):
    leaves = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, [None if x is None else x.clone() for x in leaves])


def _static_copy(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A buffer like x holding x's values.  It is a normal tensor, even
    when made under inference mode, so that a later call outside
    inference mode may still copy into it."""
    if x is None:
        return None
    with torch.inference_mode(False), torch.no_grad():
        return torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)


# ---------------------------------------------------------------------------
# one program, and the cache of a kind of them
# ---------------------------------------------------------------------------

def _capture_mode() -> str:
    """"thread_local" in a process that has joined a process group, else
    PyTorch's default "global" (module docstring, "Scoped programs")."""
    import torch.distributed as dist
    joined = dist.is_available() and dist.is_initialized()
    return "thread_local" if joined else "global"


class Program:
    """One captured body: its static input buffers, its graph and static
    output (None on the CPU), the launches its capture recorded by
    counter, and what it holds (its scope among them)."""

    def __init__(self, owners: tuple, body: Callable, spec, static_in: list,
                 scope=None):
        self.owner_refs = [weakref.ref(o) for o in owners]
        self.body, self.spec, self.static_in = body, spec, static_in
        self.scope = scope
        self.graph = None
        self.static_out = None
        self.launches: List[Tuple[int, int]] = []
        self.held: Dict[int, object] = {}
        self.capture_s = 0.0

    def _call_body(self, owner):
        with _holding(self.held):
            return self.body(owner, *_unflatten(self.spec, self.static_in))

    def capture(self, owner, device: torch.device, name: str) -> None:
        snapshot = list(_COUNTERS)
        before = [getattr(o, a) for o, a in snapshot]
        graph = torch.cuda.CUDAGraph()
        pool, idx = _pool(device), _device_index(device)
        t0 = time.perf_counter()
        captured = False
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    graph, pool=pool[0], capture_error_mode=_capture_mode()):
                out = self._call_body(owner)
            captured = True
        finally:
            after = [getattr(o, a) for o, a in snapshot]
            for (o, a), n in zip(snapshot, before):
                setattr(o, a, n)
            if not captured and pool[1] == 0 and _POOLS.get(idx) is pool:
                del _POOLS[idx]             # retired with the failed graph
        pool[1] += 1
        weakref.finalize(self, _graph_freed, idx, pool)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.static_out = graph, out
        self.launches = [(_COUNTERS.index(c), n1 - n0)
                         for c, n0, n1 in zip(snapshot, before, after)
                         if n1 != n0]
        CAPTURES.append((name, self.capture_s))

    def run(self, owner, leaves: list):
        for s, x in zip(self.static_in, leaves):
            if s is not None:
                s.copy_(x)
        if self.graph is None:
            out = self.body(owner, *_unflatten(self.spec, self.static_in))
        else:
            self.graph.replay()
            for i, n in self.launches:
                o, a = _COUNTERS[i]
                setattr(o, a, getattr(o, a) + n)
            out = self.static_out
        return _clone_tree(out)


class ProgramCache:
    """The programs of one kind, at most `maxsize`, least recently used
    dropped first (module docstring)."""

    def __init__(self, name: str, maxsize: int):
        self.name, self.maxsize = name, maxsize
        self.entries: "collections.OrderedDict[tuple, Program]" = (
            collections.OrderedDict())
        self.misses = 0
        self.hits = 0
        self._dead: List[int] = []          # ids of owners freed since
        self._watched: set = set()
        # (slot, shape, dtype, device) -> the programs' shared static input
        self._buffers: "weakref.WeakValueDictionary[tuple, torch.Tensor]" = (
            weakref.WeakValueDictionary())
        _CACHES.append(self)

    def __len__(self) -> int:
        return len(self.entries)

    def keys(self) -> List[tuple]:
        """The static keys of the live programs (without the owner and
        the shapes), least recently used first."""
        return [k[0] for k in self.entries]

    def clear(self) -> None:
        with _LOCK:
            self.entries.clear()

    def _static(self, slot: int, x: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
        """The shared static buffer of input `slot` at x's shape, dtype and
        device (made on first use), holding x's values."""
        if x is None:
            return None
        key = (slot, tuple(x.shape), x.dtype, x.device)
        buf = self._buffers.get(key)
        if buf is None:
            buf = _static_copy(x)
            self._buffers[key] = buf
        else:
            buf.copy_(x)
        return buf

    def buffers(self) -> List[torch.Tensor]:
        """The live shared static input buffers."""
        return list(self._buffers.values())

    def _owner_freed(self, owner_id: int) -> None:
        # runs inside the garbage collector, maybe during another
        # program's capture: only note it; _purge drops the programs
        self._dead.append(owner_id)

    def _purge(self) -> None:
        while self._dead:
            owner_id = self._dead.pop()
            self._watched.discard(owner_id)
            for k in [k for k in self.entries if owner_id in k[1]]:
                del self.entries[k]

    def __call__(self, key: tuple, owner, inputs, make_body: Callable,
                 scope=None):
        """The program for (key, owner, scope, inputs' shapes) run on inputs
        (a sequence of trees of tensors, all on one device); make_body() ->
        body, with body(owner, *inputs) -> a tree of tensors it made, is
        called on a miss.  owner: one object, or a tuple of them.  scope:
        None, or what else the body depends on (module docstring, "Scoped
        programs")."""
        owners = owner if isinstance(owner, tuple) else (owner,)
        leaves: list = []
        spec = _flatten(tuple(inputs), leaves)
        shapes = tuple(None if x is None else (tuple(x.shape), x.dtype, x.device)
                       for x in leaves)
        full = (key, tuple(map(id, owners)), spec, shapes,
                None if scope is None else scope.key)
        with _LOCK:
            purge()
            prog = self.entries.get(full)
            if prog is not None and all(
                    r() is o for r, o in zip(prog.owner_refs, owners)):
                self.entries.move_to_end(full)
                self.hits += 1
                return prog.run(owner, leaves)
            devices = {x.device for x in leaves if x is not None}
            if len(devices) != 1:
                raise ValueError(f"a program's inputs lie on one device; got "
                                 f"{sorted(map(str, devices))}")
            device = devices.pop()
            if scope is not None:
                scope.check(device)
            self.misses += 1
            prog = Program(owners, make_body(), spec,
                           [self._static(i, x) for i, x in enumerate(leaves)],
                           scope)
            out = _clone_tree(prog._call_body(owner))   # the eager miss run
            if device.type == "cuda":
                prog.capture(owner, device, self.name)
            self.entries[full] = prog
            self.entries.move_to_end(full)
            for o in owners:
                if id(o) not in self._watched:
                    self._watched.add(id(o))
                    weakref.finalize(o, self._owner_freed, id(o))
            while len(self.entries) > self.maxsize:
                self.entries.popitem(last=False)
            return out


def caches() -> List[ProgramCache]:
    return list(_CACHES)


def purge() -> None:
    """Drop every program whose owner (or one of whose owners) has been
    freed, in every cache, with its graph; its pool memory returns at the
    next empty_cache.  Every program call runs it first; a caller that
    frees an owner and then runs other work (a plain step, another
    request) runs it itself."""
    with _LOCK:
        for cache in _CACHES:
            cache._purge()


def drop_scoped() -> None:
    """Drop every program made with a scope, in every cache, with its graph
    (module docstring, "Scoped programs")."""
    with _LOCK:
        for cache in _CACHES:
            for k in [k for k in cache.entries if k[-1] is not None]:
                del cache.entries[k]


def clear_all() -> None:
    """Drop every program of every cache (their graphs and static
    buffers; the pool's memory returns at the next empty_cache)."""
    for cache in _CACHES:
        cache.clear()


def stats() -> Dict[str, Dict[str, int]]:
    """{cache name: entries, misses, hits}."""
    return {c.name: {"entries": len(c), "misses": c.misses, "hits": c.hits}
            for c in _CACHES}


def static_bytes(device) -> int:
    """Bytes of the programs' shared static input buffers on `device`."""
    device = torch.device(device)
    seen = {}
    for cache in _CACHES:
        for buf in cache.buffers():
            if buf.device.type == device.type and (
                    device.index is None or buf.device.index == device.index):
                seen[buf.data_ptr()] = buf.untyped_storage().nbytes()
    return sum(seen.values())


def pool_bytes(device) -> int:
    """Bytes the shared graph pool reserves on `device` (0 before the
    first capture there), from the caching allocator's snapshot."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    idx = _device_index(device)
    if idx not in _POOLS:
        return 0
    pool = tuple(_POOLS[idx][0])
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if seg["device"] == idx
               and tuple(seg.get("segment_pool_id", ())) == pool)
