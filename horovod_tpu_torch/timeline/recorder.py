"""Recorder: model-DAG / tensor-shape / gradient-manifest dumps and the
step hook — the port of ``horovod_tpu/timeline/recorder.py``.

The reference takes its DAG from the step function's jaxpr; the port
takes it from ``torch.fx.experimental.proxy_tensor.make_fx`` of the
step, the aten-level graph of what runs: every operation, forward and
backward, the collectives, and the port's kernels, which are
``torch.library`` ops (``hvd.flash_fwd``, ``hvd.flash_bwd_dq``,
``hvd.flash_bwd_dkv``, ``hvd.fused_update``) so each launch is one node
with edges from its inputs.  The files are the reference's:

* ``dag.gml`` — input, op and output nodes with shape / dtype / kind
  attributes and def→use edges (networkx reads it with ``read_gml``);
* ``tensor_shapes.json``, ``tensor_dtypes.json`` and
  ``gradient_name_list.json`` — gradients keyed ``gradients/<path>`` by
  the converter's leaf names (``utils/tree.tree_leaf_names``), shapes in
  the reference's (flax) layout when the model's layouts are given;
* ``metadata.json`` — ``platform`` is ``"gpu"`` on a card.

``make_fx`` runs the function it traces (a real-tensor trace, so on the
card the kernels launch): :meth:`Recorder.record_step_function` puts
every tensor it was given back as it was afterwards, so the step's
state is left unchanged.  Outputs land in ``<dir>/<rank>/`` next to the
timeline's ``comm.json``.
"""

from __future__ import annotations

import contextlib
import json
import operator
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

from .. import core
from ..utils import env as env_util
from ..utils.logging import get_logger
from ..utils.tree import tree_flatten_with_path
from .timeline import timeline

log = get_logger(__name__)


def _gml_escape(s: str) -> str:
    return s.replace('"', "'")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _first_tensor(val):
    if isinstance(val, torch.Tensor):
        return val
    if isinstance(val, (list, tuple)):
        for v in val:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _op_label(target) -> str:
    """``aten.mm``, ``hvd.flash_fwd``, ``c10d.allreduce_``: an op's
    namespace and name without its overload."""
    if isinstance(target, torch._ops.OpOverload):
        ns, name = target.name().split("::", 1)
        return f"{ns}.{name.split('.')[0]}"
    return getattr(target, "__name__", str(target))


def _written_args(target) -> List[int]:
    """Positions of the arguments an op writes in place (``Tensor(a!)``)."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return []
    return [i for i, a in enumerate(schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write]


def fx_dag(graph: torch.fx.Graph) -> tuple:
    """(nodes, edges) from an fx graph of aten-level ops: nodes are the
    graph's inputs, its operations and its outputs, with the shape and
    dtype of each one's (first) tensor; edges follow def→use.  A
    ``getitem`` of a multi-output op is that op; an op that writes an
    input in place becomes that input's producer for later uses, so the
    edges follow the data through in-place updates."""
    nodes: List[Dict[str, Any]] = []
    edges: List[tuple] = []
    producer: Dict[torch.fx.Node, int] = {}

    def add_node(label: str, kind: str, val=None) -> int:
        nid = len(nodes)
        node = {"id": nid, "label": label, "kind": kind}
        t = _first_tensor(val)
        if t is not None:
            node["shape"] = list(t.shape)
            node["dtype"] = _dtype_name(t.dtype)
        nodes.append(node)
        return nid

    n_in = 0
    for n in graph.nodes:
        if n.op == "placeholder":
            producer[n] = add_node(f"input{n_in}", "input", n.meta.get("val"))
            n_in += 1
        elif n.op == "call_function":
            if n.target is operator.getitem:
                if n.args[0] in producer:
                    producer[n] = producer[n.args[0]]
                continue
            nid = add_node(_op_label(n.target), "op", n.meta.get("val"))
            seen = set()
            for a in n.all_input_nodes:
                src = producer.get(a)
                if src is not None and src not in seen:
                    edges.append((src, nid))
                    seen.add(src)
            producer[n] = nid
            for i in _written_args(n.target):
                a = n.args[i] if i < len(n.args) else None
                for m in (a if isinstance(a, (list, tuple)) else [a]):
                    if isinstance(m, torch.fx.Node):
                        producer[m] = nid
        elif n.op == "output":
            outs = n.args[0]
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            for i, o in enumerate(outs):
                nid = add_node(f"output{i}", "output",
                               o.meta.get("val") if isinstance(
                                   o, torch.fx.Node) else None)
                if isinstance(o, torch.fx.Node) and o in producer:
                    edges.append((producer[o], nid))
    return nodes, edges


def write_gml(nodes: Sequence[dict], edges: Sequence[tuple], path: str) -> None:
    """Minimal GML writer (the reference's format, which networkx's
    ``read_gml`` reads)."""
    with open(path, "w") as f:
        f.write("graph [\n  directed 1\n")
        for n in nodes:
            f.write(f'  node [\n    id {n["id"]}\n'
                    f'    label "{_gml_escape(str(n["label"]))}"\n')
            if "shape" in n:
                f.write(f'    shape "{tuple(n["shape"])}"\n')
            if "dtype" in n:
                f.write(f'    dtype "{n["dtype"]}"\n')
            f.write(f'    kind "{n["kind"]}"\n  ]\n')
        for s, t in edges:
            f.write(f"  edge [\n    source {s}\n    target {t}\n  ]\n")
        f.write("]\n")


def structure_dag(names: Sequence[str]) -> tuple:
    """(nodes, edges) for the aggregation step's own dataflow —
    grad_i → allreduce_i → var_i: the DAG of a frontend that has no
    traced graph (``horovod_tpu_torch.torch``'s optimizer), in the
    same node vocabulary as :func:`fx_dag`."""
    nodes, edges = [], []
    for name in names:
        g = len(nodes)
        nodes.append({"id": g, "label": f"grad/{name}", "kind": "input"})
        a = len(nodes)
        nodes.append({"id": a, "label": f"allreduce/{name}", "kind": "op"})
        v = len(nodes)
        nodes.append({"id": v, "label": name, "kind": "output"})
        edges.extend([(g, a), (a, v)])
    return nodes, edges


def write_gradient_manifest(rec: "Recorder", names: Sequence[str],
                            shapes: Dict[str, list]) -> None:
    """gradient_name_list.json + tensor_shapes.json (reference
    recorder.py:176-193 gradient name registration)."""
    with open(rec._path("gradient_name_list.json"), "w") as f:
        json.dump(list(names), f, indent=1)
    with open(rec._path("tensor_shapes.json"), "w") as f:
        json.dump(shapes, f, indent=1)


@contextlib.contextmanager
def _restoring(tensors: Sequence[torch.Tensor]):
    """Every tensor in ``tensors`` put back as it was on exit."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)


class Recorder:
    """Capture and dump the model/step structure::

        rec = Recorder(trace_dir)           # or env HVD_TRACE_DIR
        rec.record_step_function(step.eager, state, x, y)  # dag.gml
        rec.register_gradients(state.params, canonical_layouts(model))
        rec.dump_metadata(model="gpt2", batch=4)
    """

    def __init__(self, trace_dir: Optional[str] = None,
                 rank: Optional[int] = None):
        trace_dir = trace_dir or env_util.get_str(env_util.HVD_TRACE_DIR) \
            or env_util.get_str(env_util.HVD_TIMELINE)
        self.enabled = bool(trace_dir) and env_util.get_bool(
            env_util.HVD_TRACE_ON, True)
        self.rank = rank if rank is not None else (
            core.process_rank() if core.is_initialized() else 0)
        self.dir = os.path.join(trace_dir, str(self.rank)) if trace_dir \
            else None
        if self.enabled and self.dir:
            os.makedirs(self.dir, exist_ok=True)

    def _path(self, name: str) -> str:
        assert self.dir is not None
        return os.path.join(self.dir, name)

    def record_step_function(self, fn: Callable, *example_args,
                             **example_kwargs) -> Optional[torch.fx.Graph]:
        """Trace ``fn`` with ``make_fx`` and dump dag.gml +
        tensor_shapes.json; returns the traced graph.  Every tensor of
        the arguments is an input of the graph and is put back as it
        was once the trace has run."""
        if not self.enabled:
            return None
        from torch.fx.experimental.proxy_tensor import make_fx
        from torch.utils import _pytree as pytree

        flat, spec = pytree.tree_flatten((example_args, example_kwargs))
        idx = [i for i, v in enumerate(flat) if isinstance(v, torch.Tensor)]

        def traced(*tensors):
            leaves = list(flat)
            for i, t in zip(idx, tensors):
                leaves[i] = t
            args, kwargs = pytree.tree_unflatten(leaves, spec)
            return fn(*args, **kwargs)

        tensors = [flat[i] for i in idx]
        with _restoring(tensors):
            gm = make_fx(traced)(*tensors)
        nodes, edges = fx_dag(gm.graph)
        write_gml(nodes, edges, self._path("dag.gml"))
        shapes = {f'{n["label"]}.{n["id"]}': n["shape"]
                  for n in nodes if "shape" in n}
        with open(self._path("tensor_shapes.json"), "w") as f:
            json.dump(shapes, f, indent=1)
        log.debug("recorder: dag.gml with %d nodes, %d edges",
                  len(nodes), len(edges))
        return gm.graph

    def register_gradients(self, grads: Any,
                           layouts: Optional[Mapping[str, Any]] = None
                           ) -> None:
        """gradient_name_list.json from the leaf paths, and each
        gradient's shape and dtype merged into tensor_shapes.json and
        tensor_dtypes.json under the same ``gradients/<path>`` name.
        With ``layouts`` (the model's ``convert.canonical_layouts``) the
        shapes are the reference's (flax) ones."""
        if not self.enabled:
            return
        leaves = tree_flatten_with_path(grads)
        paths = ["gradients/" + "/".join(path) for path, _ in leaves]
        with open(self._path("gradient_name_list.json"), "w") as f:
            json.dump(paths, f, indent=1)
        shapes: Dict[str, list] = {}
        dtypes: Dict[str, str] = {}
        for name, (path, leaf) in zip(paths, leaves):
            if hasattr(leaf, "shape"):
                key = "/".join(path)
                lay = layouts.get(key) if layouts is not None else None
                shapes[name] = list(lay.flax_shape) if lay is not None \
                    else list(leaf.shape)
                dtypes[name] = _dtype_name(getattr(leaf, "dtype",
                                                   "float32"))
        if shapes:
            # merge, don't overwrite: record_step_function and earlier
            # calls (a second parameter group) contribute keys too
            for name, payload in (("tensor_shapes.json", shapes),
                                  ("tensor_dtypes.json", dtypes)):
                path = self._path(name)
                if os.path.isfile(path):
                    with open(path) as f:
                        existing = json.load(f)
                    existing.update(payload)
                    payload = existing
                with open(path, "w") as f:
                    json.dump(payload, f, indent=1)

    def dump_metadata(self, **meta: Any) -> None:
        """metadata.json: rank, sizes, ``platform`` (``"gpu"`` on a card,
        else ``"cpu"``) and what the caller adds."""
        if not self.enabled:
            return
        ready = core.is_initialized()
        base = {
            "rank": self.rank,
            "size": core.size() if ready else 1,
            "local_size": core.local_size() if ready else 1,
            "platform": ("gpu" if core.device().type == "cuda" else
                         core.device().type) if ready else "cpu",
        }
        base.update(meta)
        with open(self._path("metadata.json"), "w") as f:
            json.dump(base, f, indent=1)


class TimelineHook:
    """Step-driven trace controller (reference tensorflow/recorder.py
    TimelineHook: collects only inside the [start_step, end_step]
    window).  Wrap the training loop::

        hook = TimelineHook(recorder)
        for batch in data:
            with hook.step():
                state, loss = train_step(state, batch)

    ``cuda_profile`` captures a torch.profiler trace of the window into
    ``<rank>/cuda_trace/`` (the reference's ``xla_profile``)."""

    def __init__(self, recorder: Recorder,
                 start_step: Optional[int] = None,
                 end_step: Optional[int] = None,
                 cuda_profile: bool = False):
        self.recorder = recorder
        self.start_step = start_step if start_step is not None else \
            env_util.get_int(env_util.HVD_TRACE_START_STEP, 0)
        self.end_step = end_step if end_step is not None else \
            env_util.get_int(env_util.HVD_TRACE_END_STEP, 1 << 62)
        self.cuda_profile = cuda_profile
        self._step = 0
        self._profiler = None
        if self.recorder.enabled:
            timeline.initialize(os.path.dirname(self.recorder.dir))

    def _in_window(self) -> bool:
        return self.start_step <= self._step <= self.end_step

    def step(self):
        from .profiler import (
            CUDA_TRACE_DIR, _start_cuda_trace, _stop_cuda_trace,
        )

        @contextlib.contextmanager
        def ctx():
            self._step = timeline.record_step(owner="timeline_hook")
            enabled = self.recorder.enabled and self._in_window()
            if enabled and self.cuda_profile and self._profiler is None:
                self._profiler = _start_cuda_trace()
            with timeline.span(f"step_{self._step}", "STEP"):
                yield self._step
            if self._profiler is not None and (
                    not self._in_window() or self._step >= self.end_step):
                _stop_cuda_trace(self._profiler,
                                 self.recorder._path(CUDA_TRACE_DIR))
                self._profiler = None

        return ctx()
