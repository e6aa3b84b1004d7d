"""The compiled step: a frame step captured once as a CUDA graph, replayed.

The counterpart of the JAX package's compiled step: ``@jax.jit`` on
``device_frame_step`` and ``device_frame_step_packed``
(``lidar_processing_tpu/runtime/pipeline.py:83,430``) and the jitted
``_step(frame_idx)`` of its ReplayStream (``runtime/stream.py:100-105``).
The port's step has static shapes and no host syncs
(runtime/pipeline.py), so the ~2.9k kernels it issues from Python can be
captured once per (step function, B, config) and replayed as ONE graph
launch, both hand kernels (``tier_min_d2``, ``union_find``) inside it.

``CompiledStep`` owns static inputs, (B, N, 3) f32 points and (B, N) bool
masks, N the caller's ``points`` (``config.pipeline.max_points`` when
it gives none). A call copies the caller's
frames into them on the current stream (device to device, ordered before
the replay), replays the graph on that stream and returns the static
outputs, which the next call overwrites. Static inputs, rather than a
device index into resident frames as the JAX ``_step`` takes: one graph
then serves every caller (ReplayStream's resident frames, bench's
gathered batches, golden's frames loaded one by one), and nothing on the
host is written while a replay that reads it may still be queued.

Before the capture the step runs eagerly on a side stream
(``WARMUP_STEPS``): that builds the kernel library and fills the
``lru_cache``d device tables (``ops/stixel.py::_tier_layout``,
``ops/clustering.py``), whose pageable host-to-device copies a capture
refuses. The capture keeps CUDA's global mode: a sync, an illegal call or
a failed allocation inside the step raises, and nothing here falls back
to the eager step. The CPU has no CUDA graphs; there the step is called by
name, and ``CompiledStep`` raises.

Launch accounting: each kernel wrapper counts the launches it makes from
Python (``kernels/_build.py::launch``): the warm-up steps' and the one the
capture records. A replay runs the graph's kernels without Python, so it
adds nothing to those counts. What replays launch is read from the
graph itself: ``kernel_nodes(name)`` counts the graph's kernel nodes of a
CUDA kernel function (CUDA's DOT print of the captured graph), and
``replays`` counts the graph's launches. torch.profiler, which records a
replay's kernels node by node, cross-checks them on the card
(``tools/kernel_bench.py::kernel_counts``).

The registry (``replay_copy``, ``programs``) holds the programs of
the parallel path (``parallel/*``), the counterparts of the JAX
package's jitted programs built once per mesh and config through
``functools.lru_cache`` (``parallel/spatial.py:165``,
``frame_spatial.py:85``) or ``static_argnames`` (``sharded.py:53,93``).
It keys each graph on what fixes the captured work: the program and what
it closes over (a mesh's layout: shards and ranks per axis, this rank,
its device and process group; see ``parallel/mesh.py::Mesh.layout``),
its configs, its static inputs' shape and its device; equal meshes share
one graph. A program whose mesh has a process group holds its NCCL
collectives inside the graph: the warm-up steps run the first
collective, which makes the communicator, before the capture.
``replay_copy`` returns a device-to-device copy of every output, as the
JAX programs return fresh arrays; ``release_graphs`` frees one entry or
all of them (the next call captures again). On a process group every
rank must capture, replay and release the same programs in the same
order, as every rank calls a collective.

``live_graphs()`` counts the CompiledSteps whose graph is held,
registered ones included; a short torch.profiler profile of kernels
launched from Python loses events while one is
(``tools/kernel_bench.py::profiled`` refuses to run then), and
``release()`` frees a graph before its owner goes.
"""

from __future__ import annotations

import functools
import os
import re
import tempfile
import time
import warnings
import weakref
from typing import Callable

import torch

from ..types import map_leaves

WARMUP_STEPS = 2   # eager steps on a side stream before the capture
_LIVE: "weakref.WeakSet" = weakref.WeakSet()   # CompiledSteps holding a graph
_REGISTRY: dict = {}   # registered programs: key -> CompiledStep


def live_graphs() -> int:
    """The CompiledSteps in this process that hold a captured graph."""
    return len(_LIVE)


def capture(run: Callable, device: torch.device):
    """Capture one call of ``run()`` as a CUDA graph with its own memory
    pool, instantiated; (the graph, the call's outputs). The graph keeps
    its cudaGraph_t beside the executable one, for ``debug_dump`` (its
    DOT print). Raises on a device that is not a card, and with CUDA's
    error when the capture fails."""
    if device.type != "cuda":
        raise RuntimeError(f"CompiledStep: {device} has no CUDA graphs; "
                           f"call the eager step there")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="global"):
        outputs = run()
    graph.instantiate()
    return graph, outputs


_DOT_NODE = re.compile(r'^\s*"graph_\d+_node_\d+"\s*\[(.*?)\];',
                       re.S | re.M)


def dot_nodes(dot: str) -> list:
    """The attribute text of each node of a CUDA graph's DOT print (its
    edges left out)."""
    return _DOT_NODE.findall(dot)


def node_kind(node: str) -> str:
    """The kind of a node of a CUDA graph's DOT print (KERNEL, MEMCPY,
    MEMSET, EVENT_RECORD, ...), from its attribute text."""
    kind = re.search(r'label="\{\s*(\w+)', node)
    return kind.group(1) if kind else ""


def _mangled_name(symbol: str) -> str:
    """The unqualified function name of an Itanium-mangled symbol
    (``_Z<len><name>...`` or nested ``_ZN<len><name>...<len><name>E...``),
    or "" when it is none of these."""
    nested = symbol.startswith("_ZN")
    i, name = (3 if nested else 2), ""
    while True:
        digits = re.match(r"\d+", symbol[i:])
        if digits is None:
            return name
        i += len(digits.group())
        name, i = symbol[i:i + int(digits.group())], i + int(digits.group())
        if not nested:
            return name


def names_kernel(text: str, kernel: str) -> bool:
    """Whether `text` names the CUDA kernel function `kernel`: demangled
    (as torch.profiler gives it) or mangled (as CUDA's DOT print does),
    in any namespace."""
    return (re.search(rf"(?<!\w){kernel}(?!\w)", text) is not None
            or any(_mangled_name(sym) == kernel
                   for sym in re.findall(r"_Z\w+", text)))


def _warm_up(run: Callable, device: torch.device) -> None:
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            run()
    torch.cuda.current_stream(device).wait_stream(side)


class CompiledStep:
    """``fn(xyzs, masks, config)`` for B frames, captured once, replayed
    by each call.

    fn is a batched step of runtime/pipeline.py
    (``device_frame_step_packed_batched``, ``device_frame_step_batched``)
    or any function of (B, N, 3) f32 points and (B, N) bool masks with
    static shapes and no host syncs, returning a tensor or a tuple of
    tensors; config is what fn takes beside them (any value). N is
    `points`, or ``config.pipeline.max_points`` when it is None; a
    single-frame program takes B = 1. Built on the card (``device=None``
    means ``cuda``); raises on the CPU and when the capture fails.

    Attributes: ``outputs`` (the static outputs), ``capture_s`` (seconds
    of the capture alone), ``pool_bytes`` (device memory the graph's pool
    took), ``replays`` (the graph's launches so far).
    """

    def __init__(self, fn: Callable, config, batch: int, device=None,
                 points: int = None):
        self.device = dev = torch.device(device if device is not None
                                         else "cuda")
        n = config.pipeline.max_points if points is None else points
        self._xyz = torch.zeros((batch, n, 3), dtype=torch.float32,
                                device=dev)
        self._mask = torch.zeros((batch, n), dtype=torch.bool, device=dev)
        run = functools.partial(fn, self._xyz, self._mask, config)
        on_card = dev.type == "cuda"
        if on_card:
            _warm_up(run, dev)
            # the capture empties the cache first; do it here, so the
            # growth of the reserved memory is the graph's pool alone
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        self._graph, self.outputs = capture(run, dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = (torch.cuda.memory_reserved(dev) - reserved
                           if on_card else 0)
        self.replays = 0
        self._dot = None
        _LIVE.add(self)

    def dot(self) -> str:
        """The captured graph's DOT print (CUDA's
        cudaGraphDebugDotPrint, verbose), read once."""
        if self._dot is None:
            with tempfile.TemporaryDirectory() as tmp, \
                    warnings.catch_warnings():
                # torch warns at every debug_dump call
                warnings.simplefilter("ignore")
                path = os.path.join(tmp, "graph.dot")
                self._graph.debug_dump(path)
                with open(path) as f:
                    self._dot = f.read()
        return self._dot

    def kernel_nodes(self, kernel: str) -> int:
        """The graph's nodes that launch the CUDA kernel function
        `kernel`: the launches of it that each replay makes."""
        return sum(names_kernel(node, kernel)
                   for node in dot_nodes(self.dot()))

    def node_kinds(self) -> dict:
        """{node kind: nodes} of the captured graph."""
        kinds: dict = {}
        for node in dot_nodes(self.dot()):
            kinds[node_kind(node)] = kinds.get(node_kind(node), 0) + 1
        return kinds

    def nccl_nodes(self) -> int:
        """The graph's kernel nodes that run an NCCL kernel (a collective
        or a P2P captured with it; NCCL may copy with a MEMCPY node
        instead where the group has one rank)."""
        return sum(node_kind(node) == "KERNEL" and "nccl" in node.lower()
                   for node in dot_nodes(self.dot()))

    def release(self) -> None:
        """Free the graph and its outputs (its pool returns to the
        allocator's cache); a later call raises."""
        self._graph = self.outputs = None
        _LIVE.discard(self)

    def __call__(self, xyzs: torch.Tensor, masks: torch.Tensor):
        """Copy B frames (xyzs (B, N, 3), masks (B, N)) into the static
        inputs, replay, and return the static outputs: the next call
        overwrites them, so copy what must outlive it (stream order
        protects a copy enqueued before the next call)."""
        if xyzs.shape != self._xyz.shape or masks.shape != self._mask.shape:
            raise ValueError(f"CompiledStep: captured for xyzs "
                             f"{tuple(self._xyz.shape)} and masks "
                             f"{tuple(self._mask.shape)}, got "
                             f"{tuple(xyzs.shape)} and {tuple(masks.shape)}")
        if self._graph is None:
            raise RuntimeError("CompiledStep: the graph was released")
        self._xyz.copy_(xyzs)
        self._mask.copy_(masks)
        self._graph.replay()
        self.replays += 1
        return self.outputs


def uses_graph(device, eager: bool = False) -> bool:
    """The route every entry point takes: the compiled step on the card
    unless `eager`; elsewhere the eager step (the CPU has no CUDA
    graphs)."""
    return not eager and torch.device(device).type == "cuda"


def batched_step(fn: Callable, config, batch: int, device,
                 eager: bool = False) -> Callable:
    """``fn(xyzs, masks, config)`` for B frames as a callable of (xyzs,
    masks) on the route of ``uses_graph``: a CompiledStep, or fn called
    eagerly."""
    if uses_graph(device, eager):
        return CompiledStep(fn, config, batch, device)
    return functools.partial(fn, config=config)


def replay_copy(key: tuple, fn: Callable, config, xyzs: torch.Tensor,
                masks: torch.Tensor, device):
    """``fn(xyzs, masks, config)`` for (B, N) frames on `device`, replayed
    on its registered graph, which the first call with an equal key
    captures; a device-to-device copy of each output, which no later
    replay overwrites. `key` names the program and what fn closes over;
    with config, B, N and the device it keys the registry (module
    docstring)."""
    b, n = masks.shape
    full = (key, config, b, n, torch.device(device))
    step = _REGISTRY.get(full)
    if step is None:
        step = _REGISTRY[full] = CompiledStep(fn, config, b, device, n)
    return map_leaves(torch.clone, step(xyzs, masks))


def programs() -> dict:
    """The registered programs: {registry key: CompiledStep}."""
    return dict(_REGISTRY)


def release_graphs(key: tuple = None) -> int:
    """Free the registered graph of `key` (a key of ``programs()``), or
    every registered graph when `key` is None; the next call of a freed
    program captures it again. Returns how many were freed."""
    keys = list(_REGISTRY) if key is None else [key] if key in _REGISTRY \
        else []
    for k in keys:
        _REGISTRY.pop(k).release()
    return len(keys)
