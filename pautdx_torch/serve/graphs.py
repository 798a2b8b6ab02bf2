"""CUDA graphs of the served D-FINE forward.

``build_serving_model`` returns a :class:`GraphedDFine`: a ``DFine`` (same
modules, same state dict) whose forward replays a CUDA graph of
``DFine.forward`` in place of its ~1,000 eager launches, where that gives
the eager result. A served batch then costs the host one input copy, one
replay and the output copies, and the card sets the pace.

A call replays when :func:`eager_reason` finds nothing against it: the
model in eval mode and grad off, ``train`` false and no ``denoising``
group, no int8 site set or recording (``ops.qconv.Int8Site``), no forward
pre-hook on a submodule and no global module hook, the input on CUDA.
Every other call runs ``DFine.forward`` eagerly, as any ``DFine`` does.
The rule costs a served call a few attribute reads: the submodules' hooks
are scanned once and again only after a hook was registered anywhere
(every registration advances ``RemovableHandle.next_id``), or on every
call while a pre-hook keeps the model eager, so that its removal is seen.

One graph a key: the input's shape, dtype and device, and the submodules
that carry forward hooks. The first call with a new key copies its input
into the graph's static input, runs one eager forward on a side stream
(cuDNN's plans, the model's cached anchors and projection settle), then
captures ``DFine.forward`` into the graph, in a memory pool that the
model's graphs share; a capture that fails raises. Every call with that key
copies its input into the static input and replays on the current stream,
so stream order with the caller's copies holds as in eager. It returns
copies of the outputs, which a later call does not overwrite. A
submodule's forward hooks run once a call, after the replay, with the
tensors that the module saw in the graph: they hold this call's values
until the next call of the model, so a hook that keeps one clones it, in
stream order. A hook that returns a replacement output raises: the graph
cannot take it. Parameters changed in place (``load_state_dict``,
``copy_``) are seen by the replay; ``Module.to`` and the other
``Module._apply`` casts drop the graphs.

On a replayed call ``span("dfine.forward")`` covers the key, the input
copy, the replay, the hooks and the output copies; the rule before it
stays outside, since the eager forward it may choose opens its own.

``CAPTURES`` and ``REPLAYS`` count captures and replays (two of
``utils.profiling.LAUNCH_COUNTERS``); a replay also advances the per-op
launch counters by what its capture counted (1 ``aifi_attention`` and 3
``onehot_gather`` a served forward), so they still count kernels run.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module
from torch.utils import _pytree as pytree
from torch.utils.hooks import RemovableHandle

from pautdx_torch.models.vision.dfine import DFine
from pautdx_torch.ops.qconv import Int8Site
from pautdx_torch.utils.profiling import advance_launches, launch_counts, span

CAPTURES = 0
REPLAYS = 0


def eager_reason(model: "GraphedDFine", images: torch.Tensor,
                 train: bool = False,
                 denoising: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Optional[str]:
    """Why ``model(images, train, denoising)`` runs ``DFine.forward``
    eagerly, or None where it replays a graph."""
    if train or model.training:
        return "training mode"
    if torch.is_grad_enabled():
        return "grad enabled"
    if denoising is not None:
        return "a denoising group"
    scan = model.scan()
    if any(s.int8_weight is not None or s.int8_recording
           for s in scan.int8_sites):
        return "int8 sites set or recording"
    if scan.pre_hooked:
        return "a forward pre-hook on a submodule"
    if _module._global_forward_pre_hooks or _module._global_forward_hooks:
        return "a global module hook"
    if images.device.type != "cuda":
        return f"input on {images.device.type}"
    return None


class _Scan(NamedTuple):
    """The submodules' hook state: ``RemovableHandle.next_id`` when it was
    taken (None while a pre-hook keeps the model eager: scan each call),
    whether a submodule carries a forward pre-hook, the submodules that
    carry forward hooks, and the int8 sites."""
    stamp: Optional[int]
    pre_hooked: bool
    hooked: Tuple[nn.Module, ...]
    int8_sites: Tuple[Int8Site, ...]


class _Graph:
    """One capture: the graph, its static input, what the forward returned
    (flattened), each hooked submodule's calls in order, and the launch
    counters' change over the capture."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static: torch.Tensor,
                 out: Any, calls: List[Tuple[nn.Module, tuple, dict, Any]],
                 launches: Dict[str, int]):
        self.graph, self.static = graph, static
        self.leaves, self.spec = pytree.tree_flatten(out)
        self.calls, self.launches = calls, launches

    def replay(self, images: torch.Tensor) -> Any:
        global REPLAYS
        self.static.copy_(images)
        self.graph.replay()
        REPLAYS += 1
        advance_launches(self.launches)
        for module, args, kwargs, out in self.calls:
            for hook_id, hook in list(module._forward_hooks.items()):
                if hook_id in module._forward_hooks_with_kwargs:
                    result = hook(module, args, kwargs, out)
                else:
                    result = hook(module, args, out)
                if result is not None:
                    raise RuntimeError(
                        f"a forward hook on {type(module).__name__} "
                        f"returned a replacement output, which a replayed "
                        f"graph cannot take")
        # one copy a distinct tensor, so aliases stay aliases
        copies: Dict[int, torch.Tensor] = {}
        for t in self.leaves:
            if id(t) not in copies:
                copies[id(t)] = t.clone()
        return pytree.tree_unflatten([copies[id(t)] for t in self.leaves],
                                     self.spec)


class GraphedDFine(DFine):
    """A ``DFine`` whose served calls replay CUDA graphs (module
    docstring)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = None
        self._scan: Optional[_Scan] = None

    def forward(self, images: torch.Tensor, train: bool = False,
                denoising: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
        if eager_reason(self, images, train, denoising) is not None:
            return super().forward(images, train, denoising)
        with span("dfine.forward"):
            hooked = self._scan.hooked
            key = (tuple(images.shape), images.dtype, images.device, hooked)
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.graphs[key] = self._capture(images, hooked)
            return graph.replay(images)

    def scan(self) -> _Scan:
        """The submodules' hook state, scanned again only after a hook was
        registered, or on every call while a pre-hook is there."""
        scan = self._scan
        if scan is None or scan.stamp != RemovableHandle.next_id:
            stamp = RemovableHandle.next_id
            parts = [m for m in self.modules() if m is not self]
            pre_hooked = any(m._forward_pre_hooks for m in parts)
            scan = self._scan = _Scan(
                None if pre_hooked else stamp, pre_hooked,
                tuple(m for m in parts if m._forward_hooks),
                tuple(m for m in parts if isinstance(m, Int8Site)))
        return scan

    def _apply(self, fn, *args, **kwargs):
        # moved or cast tensors: the graphs would read the old storage
        graphs = self.__dict__.get("graphs")
        if graphs:
            graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _capture(self, images: torch.Tensor,
                 hooked: Tuple[nn.Module, ...]) -> _Graph:
        """The eager warm-up on a side stream, then the capture, with the
        submodules' own forward hooks set aside and each hooked module's
        calls recorded in their place."""
        global CAPTURES
        dev = images.device
        with torch.cuda.device(dev):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            # a normal tensor, so that a later call under no_grad may copy
            # into it whatever mode this one runs in
            with torch.inference_mode(False):
                static = torch.empty(images.shape, dtype=images.dtype,
                                     device=dev)
            static.copy_(images)
            saved = {m: m._forward_hooks for m in hooked}
            calls: List[Tuple[nn.Module, tuple, dict, Any]] = []
            handles = []
            try:
                for m in hooked:
                    m._forward_hooks = type(saved[m])()
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    DFine.forward(self, static)
                torch.cuda.current_stream(dev).wait_stream(side)
                for m in hooked:
                    handles.append(m.register_forward_hook(
                        lambda mod, a, kw, o: calls.append((mod, a, kw, o)),
                        with_kwargs=True))
                before = launch_counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool):
                    out = DFine.forward(self, static)
                after = launch_counts()
            finally:
                for h in handles:
                    h.remove()
                for m, hooks in saved.items():
                    m._forward_hooks = hooks
        # the capture ran no kernel: count them at each replay instead
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        advance_launches({k: -v for k, v in launches.items()})
        CAPTURES += 1
        return _Graph(graph, static, out, calls, launches)
