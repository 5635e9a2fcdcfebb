"""ONNXModel — batch-inference pipeline Transformer on a device.

Re-designs the reference's ONNX Runtime transformer (reference:
deep-learning/.../onnx/ONNXModel.scala:145-423 — miniBatch → broadcast
model bytes → mapPartitions → OrtSession.run per batch → FlattenBatch →
softmax/argmax UDFs): the model protobuf is prepared once per fetch set
and dtype (weights uploaded, constants folded, :class:`.runner.Plan`);
rows go up in fixed-size minibatches padded to a static shape, one
upload from pinned memory per minibatch, and the softmax/argmax post-ops
run on the device before the one download per output and minibatch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ...core.dataset import Dataset
from ...core.params import (BoolParam, DictParam, IntParam, PyObjectParam,
                            StringParam)
from ...core.pipeline import Model, Transformer
from ...device import resolve_device
from .graph import Graph, load_graph, slice_at_outputs, to_model
from .runner import OnnxFunction


class ONNXModel(Model):
    """Run an ONNX model over Dataset columns on a device.

    Parameters mirror the reference (ONNXModel.scala:60-140):
    ``modelPayload`` (protobuf bytes), ``feedDict`` {onnx input → column},
    ``fetchDict`` {output column → onnx output}, ``miniBatchSize``,
    ``softMaxDict`` / ``argMaxDict`` {input column → output column};
    ``device`` is ``"cuda"`` (raises without a card) or ``"cpu"``.
    ``dtype="float32"`` runs full float32 products (TF32 off);
    ``"bfloat16"`` casts weights, inputs and every float value to bf16
    (bf16 outputs come back as float32 arrays holding the bf16 values).
    """

    modelPayload = PyObjectParam(doc="ONNX model protobuf bytes")
    feedDict = DictParam(doc="map: onnx graph input name -> dataset column")
    fetchDict = DictParam(doc="map: output column -> onnx graph output name")
    miniBatchSize = IntParam(doc="rows per device batch", default=128)
    softMaxDict = DictParam(doc="map: input col -> output col to soft-max")
    argMaxDict = DictParam(doc="map: input col -> output col to arg-max")
    dtype = StringParam(doc="compute dtype for float inputs",
                        default="float32", allowed=("float32", "bfloat16"))
    device = StringParam(doc="device to score on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")

    def __init__(self, model: Union[bytes, str, None] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set_model(model)
        self._fn_cache: Dict[Any, Any] = {}

    def _get_cache(self) -> Dict[Any, Any]:
        # instances deserialized via load_stage skip __init__
        if not hasattr(self, "_fn_cache"):
            self._fn_cache = {}
        return self._fn_cache

    # -- model loading -----------------------------------------------------
    def set_model(self, model: Union[bytes, str]) -> "ONNXModel":
        if isinstance(model, str):
            with open(model, "rb") as f:
                model = f.read()
        self.set("modelPayload", bytes(model))
        self._fn_cache = {}
        self._graph_cache = None
        return self

    def set_feed_dict(self, feed: Dict[str, str]) -> "ONNXModel":
        return self.set("feedDict", feed)

    def set_fetch_dict(self, fetch: Dict[str, str]) -> "ONNXModel":
        return self.set("fetchDict", fetch)

    def set_mini_batch_size(self, n: int) -> "ONNXModel":
        return self.set("miniBatchSize", n)

    def set_softmax_dict(self, d: Dict[str, str]) -> "ONNXModel":
        return self.set("softMaxDict", d)

    def set_argmax_dict(self, d: Dict[str, str]) -> "ONNXModel":
        return self.set("argMaxDict", d)

    def _graph(self) -> Graph:
        payload = self.get_or_default("modelPayload")
        if payload is None:
            raise ValueError("ONNXModel: modelPayload not set")
        # parse once per payload: explainers call transform per-row, and a
        # fresh Graph each call would defeat the plan cache below
        cached = getattr(self, "_graph_cache", None)
        if cached is not None and cached[0] is payload:
            return cached[1]
        graph = load_graph(payload)
        self._graph_cache = (payload, graph)
        return graph

    # -- introspection (reference ONNXModel modelInput/modelOutput) --------
    def model_inputs(self) -> List[str]:
        return self._graph().input_names

    def model_outputs(self) -> List[str]:
        return self._graph().output_names

    def slice_at_output(self, *output_names: str) -> "ONNXModel":
        """Model surgery (reference: ONNXModel.sliceAtOutput,
        ONNXModel.scala:203-209): re-point the graph at intermediate
        outputs, dropping unreachable nodes."""
        sliced = slice_at_outputs(self._graph(), list(output_names))
        clone = self.copy()
        clone.set("modelPayload", to_model(sliced).serialize())
        clone.set("fetchDict", {n: n for n in output_names})
        clone._fn_cache = {}
        return clone

    # -- execution ---------------------------------------------------------
    def _build_fn(self, graph: Graph, fetch_names: List[str],
                  softmax_of: Dict[str, str], argmax_of: Dict[str, str],
                  dev: torch.device):
        """The graph's plan + the softmax/argmax post-ops, as one call on
        the device."""
        eval_dtype = (torch.bfloat16
                      if self.get_or_default("dtype") == "bfloat16" else None)
        fn = OnnxFunction(graph, fetch_names, dtype=eval_dtype, device=dev)

        def run(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            out = fn.trace(inputs)
            post: Dict[str, torch.Tensor] = dict(out)
            for src, dst in softmax_of.items():
                post[dst] = torch.softmax(out[src], dim=-1)
            for src, dst in argmax_of.items():
                post[dst] = torch.argmax(out[src], dim=-1)
            return post

        return run

    def _transform(self, ds: Dataset) -> Dataset:
        dev = resolve_device(self.get_or_default("device"))
        graph = self._graph()
        feed: Dict[str, str] = dict(self.get_or_default("feedDict")
                                    or {n: n for n in graph.input_names})
        fetch: Dict[str, str] = dict(self.get_or_default("fetchDict")
                                     or {n: n for n in graph.output_names})
        batch = int(self.get_or_default("miniBatchSize"))

        # fetch cols whose source feeds softmax/argmax post-ops
        softmax_d = dict(self.get_or_default("softMaxDict") or {})
        argmax_d = dict(self.get_or_default("argMaxDict") or {})
        fetch_names = list(dict.fromkeys(fetch.values()))
        out_to_col = {v: k for k, v in fetch.items()}

        # columns referenced by post-op dicts must exist among fetch outputs
        softmax_of = {fetch[src]: dst for src, dst in softmax_d.items()
                      if src in fetch}
        argmax_of = {fetch[src]: dst for src, dst in argmax_d.items()
                     if src in fetch}

        key = (id(graph), tuple(fetch_names), tuple(sorted(softmax_of.items())),
               tuple(sorted(argmax_of.items())),
               self.get_or_default("dtype"), str(dev))
        cache = self._get_cache()
        if key not in cache:
            cache[key] = self._build_fn(graph, fetch_names,
                                        softmax_of, argmax_of, dev)
        fn = cache[key]

        n = ds.num_rows
        # stack each fed column to (n, ...) once; float feeds go up as
        # float32 (the bf16 rule casts them on the device)
        feeds_np: Dict[str, np.ndarray] = {}
        for onnx_name, col in feed.items():
            column = ds[col]
            if column.dtype == object:
                arr = np.stack([np.asarray(v) for v in column])
            else:
                arr = np.asarray(column)
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)
            feeds_np[onnx_name] = arr

        # on the card, one pinned staging buffer per feed, refilled per
        # minibatch: each batch's download below waits for its upload
        pin = dev.type == "cuda"
        staging: Dict[str, torch.Tensor] = {}
        chunks: Dict[str, List[np.ndarray]] = {}
        for start in range(0, n, batch):
            stop = min(start + batch, n)
            pad = batch - (stop - start)
            ins = {}
            for k, arr in feeds_np.items():
                piece = arr[start:stop]
                if pad:  # pad to the static batch by repeating the last row
                    piece = np.concatenate(
                        [piece, np.repeat(piece[-1:], pad, axis=0)], axis=0)
                if not pin:
                    ins[k] = torch.from_numpy(np.ascontiguousarray(piece))
                    continue
                buf = staging.get(k)
                if buf is None or buf.shape != piece.shape:
                    buf = staging[k] = torch.empty(
                        piece.shape, dtype=torch.from_numpy(piece[:0]).dtype,
                        pin_memory=True)
                buf.numpy()[...] = piece
                ins[k] = buf.to(dev, non_blocking=True)
            outs = fn(ins)
            for name, val in outs.items():
                val = val[:stop - start]
                if val.dtype in (torch.bfloat16, torch.float16):
                    val = val.float()
                chunks.setdefault(name, []).append(val.cpu().numpy())

        new_cols: Dict[str, Any] = {}
        for name, pieces in chunks.items():
            # fetch outputs map back to their dataset column; post-op dict
            # values are already the destination column names
            col_name = out_to_col.get(name, name)
            stacked = np.concatenate(pieces, axis=0)
            if stacked.ndim == 1:
                new_cols[col_name] = stacked
            else:
                obj = np.empty(len(stacked), dtype=object)
                for i in range(len(stacked)):
                    obj[i] = stacked[i]
                new_cols[col_name] = obj
        return ds.with_columns(new_cols)


class ImageFeaturizer(Transformer):
    """Headless-CNN embeddings (reference: deep-learning/.../onnx/
    ImageFeaturizer.scala:34-270 — ImageTransformer preprocessing feeding a
    sliced ONNXModel).  ``headless=True`` slices the network at
    ``featureTensorName`` so the output column holds flat embeddings; with
    ``headless=False`` the final network outputs (logits) are emitted.
    """

    inputCol = StringParam(doc="image column", default="image")
    outputCol = StringParam(doc="feature column", default="features")
    headless = BoolParam(doc="cut at feature tensor instead of logits",
                         default=True)
    featureTensorName = StringParam(doc="onnx value name of the feature tensor")
    onnxModel = PyObjectParam(doc="the wrapped ONNXModel")
    miniBatchSize = IntParam(doc="rows per device batch", default=128)
    device = StringParam(doc="device to score on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")

    def __init__(self, onnx_model: Optional[ONNXModel] = None, **kw):
        super().__init__(**kw)
        if onnx_model is not None:
            self.set("onnxModel", onnx_model)

    def _transform(self, ds: Dataset) -> Dataset:
        base: ONNXModel = self.get_or_default("onnxModel")
        if base is None:
            raise ValueError("ImageFeaturizer: onnxModel not set")
        resolve_device(self.get_or_default("device"))
        graph = base._graph()
        in_name = graph.input_names[0]
        if self.get_or_default("headless"):
            feat = self.get_or_default("featureTensorName")
            if not feat:
                raise ValueError("headless=True requires featureTensorName")
            model = base.slice_at_output(feat)
            out_name = feat
        else:
            model = base.copy()
            out_name = graph.output_names[0]
        model.set("feedDict", {in_name: self.get_or_default("inputCol")})
        model.set("fetchDict", {"_imgfeat": out_name})
        model.set("miniBatchSize", self.get_or_default("miniBatchSize"))
        model.set("device", self.get_or_default("device"))
        model._fn_cache = {}
        out = model.transform(ds)
        col = out["_imgfeat"]
        # flatten per-row feature maps to vectors
        if col.dtype == object:
            flat = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                flat[i] = np.asarray(v).reshape(-1)
            col = flat
        return ds.with_column(self.get_or_default("outputCol"), col)
