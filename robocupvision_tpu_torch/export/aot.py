"""Ahead-of-time serving artifacts: the serving graph as a ``torch.export``
program (the JAX package's export/aot.py, which writes a ``jax.export``
StableHLO graph).

The reference deploys by exporting (net.cfg, weights.dat) and rebuilding
the network inside a C++ engine (tester.py:121-124). Here the traced
serving graph is saved with its weights (``torch.export.save``, a
``.pt2`` archive), so a serving process loads and calls it with no model
code, registry or builder: the graph is the one that was measured (the
lane-packed serving graph, models/packed.py). With ``pallas`` each fused
chain is one opaque node of the op ``robocupvision_tpu_torch::fused_conv_chain``
(ops/cuda_packed.py), so the artifact runs kernel K2 on the card as the
live graph does; loading such an artifact needs that op registered, which
importing ``robocupvision_tpu_torch.ops.cuda_packed`` does, as a JAX
Mosaic artifact needs a TPU runtime.

One difference from ``jax.export``: that one cross-lowers (a CPU host can
write a TPU graph). ``torch.export`` traces on the device the graph's
tensors are on, so ``platforms`` may name only that device.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import os
from typing import Callable, Optional, Sequence

import torch

from robocupvision_tpu_torch.ops import cuda_packed as ckp

AOT_FNAME = "serving.pt2"


class _Ref:
    """Where a template holds the module buffer ``name``."""

    def __init__(self, name: str) -> None:
        self.name = name


def _map_tensors(obj, fn):
    """``obj`` with every tensor in its dicts, lists, tuples and dataclass
    fields replaced by ``fn(tensor)`` (and every ``_Ref`` likewise); the
    containers that hold none are returned as they are."""
    if isinstance(obj, (torch.Tensor, _Ref)):
        return fn(obj)
    if isinstance(obj, dict):
        out = {k: _map_tensors(v, fn) for k, v in obj.items()}
        return obj if all(out[k] is obj[k] for k in obj) else out
    if isinstance(obj, (list, tuple)):
        out = [_map_tensors(v, fn) for v in obj]
        if all(a is b for a, b in zip(out, obj)):
            return obj
        return type(obj)(out) if isinstance(obj, list) else tuple(out)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changed = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            nv = _map_tensors(v, fn)
            if nv is not v:
                changed[f.name] = nv
        return dataclasses.replace(obj, **changed) if changed else obj
    return obj


class _ServingGraph(torch.nn.Module):
    """A packed inference graph (models/packed.py) as an ``nn.Module``:
    every tensor it holds is a buffer, and ``forward`` is its ``method``
    (``infer_u8`` or ``infer_u8_io``) over those buffers, its chains
    through the ``torch.library`` op. Its tap lists and pool tables are
    read off the weights here, before any trace."""

    def __init__(self, graph, method: str = "infer_u8") -> None:
        super().__init__()
        if graph.chains is not None:
            graph = dataclasses.replace(graph, chains={
                **{k: ckp.with_tables(v) if isinstance(v, list) else v
                   for k, v in graph.chains.items()}, "op": True})
        names = {}

        def to_ref(t):
            if id(t) not in names:
                names[id(t)] = f"t{len(names)}"
                self.register_buffer(names[id(t)], t.detach())
            return _Ref(names[id(t)])

        self._template = _map_tensors(graph, to_ref)
        self._method = method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        graph = _map_tensors(self._template, lambda r: getattr(self, r.name))
        return getattr(graph, self._method)(x)


class _PlainServing(torch.nn.Module):
    """The zoo forward's uint8 argmax labels at ``dtype``."""

    def __init__(self, model, dtype: torch.dtype) -> None:
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.model(x.to(self.dtype)), dim=-1).to(
            torch.uint8)


def _check_platforms(platforms: Optional[Sequence[str]],
                     dev: torch.device) -> None:
    if platforms is not None and tuple(platforms) != (dev.type,):
        raise ValueError(
            f"torch.export traces on the device the graph runs on: platforms "
            f"may be ({dev.type!r},) only, not {tuple(platforms)} (it has no "
            "counterpart of jax.export's cross-lowering)")


def _drop_no_ops(prog) -> None:
    """Remove from the traced graph the nodes that do nothing at its fixed
    shapes and dtypes: ``aten.to.dtype`` to the dtype its input already
    has (the plain ops' casts, which return their input) and the
    ``aten._assert_tensor_metadata`` checks torch.export puts before them
    (the loaded module still checks its input). Each is a host call at
    every run of the graph, and they are about half of a packed graph's
    nodes."""
    g = prog.graph_module.graph
    for n in list(g.nodes):
        if n.op != "call_function":
            continue
        if n.target is torch.ops.aten._assert_tensor_metadata.default:
            g.erase_node(n)
        elif (n.target is torch.ops.aten.to.dtype and len(n.args) == 2
              and not n.kwargs and n.args[0].meta["val"].dtype == n.args[1]):
            n.replace_all_uses_with(n.args[0])
            g.erase_node(n)
    g.lint()
    prog.graph_module.recompile()


def export_fn(fn: torch.nn.Module, example_args: Sequence,
              platforms: Optional[Sequence[str]] = None) -> bytes:
    """Trace ``fn`` (a module; its buffers and parameters are saved with
    the graph) at ``example_args`` with ``torch.export``, drop the nodes
    that do nothing (:func:`_drop_no_ops`) and serialize it.
    ``platforms``, where given, must name the example inputs' device."""
    dev = next(a.device for a in example_args if isinstance(a, torch.Tensor))
    _check_platforms(platforms, dev)
    with torch.no_grad():
        prog = torch.export.export(fn, tuple(example_args))
    _drop_no_ops(prog)
    buf = io.BytesIO()
    torch.export.save(prog, buf)
    return buf.getvalue()


def load_fn(blob: bytes) -> Callable:
    """Deserialize a graph written by :func:`export_fn` into a callable
    module. A graph holding the chain op needs the op registered, which
    this module's import of ops/cuda_packed.py did."""
    return torch.export.load(io.BytesIO(blob)).module()


def export_serving(path: str, model, params=None, hw=(480, 640),
                   dtype: Optional[torch.dtype] = None, packed: bool = True,
                   raw_u8: bool = False, pallas: bool = False,
                   pallas_opts: Optional[dict] = None, int8: bool = False,
                   calib_x=None, platforms: Optional[Sequence[str]] = None,
                   fname: str = AOT_FNAME) -> str:
    """Write the uint8-label serving graph of ``model`` (with ``params``,
    the port's state_dict, or its own when None) as an AOT artifact beside
    the net.cfg/weights.dat of ``export_deployment``; traced on the
    model's device.

    The artifact maps float32 NHWC (1, H, W, C) to (1, H, W) uint8 labels,
    through the lane-packed graph when ``packed``. ``raw_u8`` (packed only)
    takes the camera's raw uint8 RGB instead, the /255, ToYUV, Normalize
    preprocessing in the graph (``infer_u8_io``). ``pallas`` traces the
    fused-chain graph, each chain one node of the K2 op (``pallas_opts``:
    the builders' ``pallas_fold_stem``/``pallas_deep``/... switches);
    ``int8`` the static int8 graph (models/packed.quantize_int8), which
    needs ``calib_x``, representative float inputs for its one calibration
    pass. On the card, a ``pallas`` graph runs once before it is traced, so
    a K2 that does not build or launch raises here."""
    if dtype is None:
        dtype = torch.bfloat16
    if raw_u8 and model.family == "label_prop":
        raise ValueError("raw_u8 export is for camera-input nets; LabelProp's "
                         "8-channel input (img+flow+prior label) is not raw "
                         "camera bytes")
    if (pallas or int8) and not packed:
        raise ValueError("pallas/int8 export requires the packed graph")
    if int8 and not pallas:
        raise ValueError("int8 export requires pallas=True (the quantized "
                         "form lives in the chain kernels)")
    if int8 and calib_x is None:
        raise ValueError("int8 export needs calib_x (representative inputs "
                         "for the one-pass calibration — zeros would "
                         "produce degenerate scales)")
    dev = model.device
    _check_platforms(platforms, dev)
    if packed:
        from robocupvision_tpu_torch.models import packed as pk

        builder = {"pb_fcn": pk.build_packed_pb_fcn,
                   "label_prop": pk.build_packed_label_prop}.get(
                       model.family, pk.build_packed_infer)
        pkw = dict(pallas=True, **(pallas_opts or {})) if pallas else {}
        pi = builder(model, params, dtype, device=dev, **pkw)
        if int8:
            with torch.no_grad():
                pi = pk.quantize_int8(pi, torch.as_tensor(calib_x).to(dev))
        fn = _ServingGraph(pi, "infer_u8_io" if raw_u8 else "infer_u8")
    elif raw_u8:
        raise ValueError("raw_u8 export requires the packed serving graph")
    else:
        if params is not None:
            model = copy.deepcopy(model)
            model.load_state_dict(params)
        fn = _PlainServing(model, dtype)

    h, w = hw
    cin = 8 if model.family == "label_prop" else 3  # LP: img+flow+prior label
    x = torch.zeros((1, h, w, cin), dtype=torch.uint8 if raw_u8
                    else torch.float32, device=dev)
    if pallas and dev.type == "cuda":
        with torch.no_grad():
            fn(x)
    blob = export_fn(fn, (x,), platforms=platforms)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, fname)
    with open(out, "wb") as f:
        f.write(blob)
    return out


def load_serving(path: str, fname: str = AOT_FNAME) -> Callable:
    """Load an AOT serving artifact written by :func:`export_serving`.
    ``path`` may be the artifact file itself or the deployment directory
    holding it."""
    if os.path.isdir(path):
        path = os.path.join(path, fname)
    with open(path, "rb") as f:
        return load_fn(f.read())
