"""A minimal ONNX weight reader, with no onnx or onnxruntime.

Counterpart of ``pautdx/compat/onnx_import.py``: the reference ships
trained ``.onnx`` artifacts for its C# host. ``load_onnx_initializers``
walks the protobuf wire format and returns the graph's initializers
(weights) by name; ``import_msc_onnx`` loads the reference's
MultiSignalClassifier export into the port's ``MultiSignalClassifier``.

Wire-format facts used (onnx.proto):
- ModelProto field 7  = graph (GraphProto, length-delimited)
- GraphProto field 5  = initializer (repeated TensorProto)
- TensorProto fields: 1 dims (int64, repeated), 2 data_type (enum),
  4 float_data (packed floats), 8 name (string), 9 raw_data (bytes)
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.device import Device
from pautdx_torch.models.signal import MultiSignalClassifier

_FLOAT = 1
_INT64 = 7


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a proto message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            val, i = _read_varint(buf, i)
            yield field, wire, val
        elif wire == 2:                    # length-delimited
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:                    # 32-bit
            yield field, wire, buf[i:i + 4]
            i += 4
        elif wire == 1:                    # 64-bit
            yield field, wire, buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_tensor(buf: bytes):
    dims = []
    dtype = _FLOAT
    name = ""
    raw = None
    floats = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 8 and wire == 2:
            name = val.decode()
        elif field == 9 and wire == 2:
            raw = val
        elif field == 4 and wire == 2:     # packed float_data
            floats = list(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 4 and wire == 5:
            floats.append(struct.unpack("<f", val)[0])
    if raw is not None:
        if dtype == _FLOAT:
            arr = np.frombuffer(raw, np.float32)
        elif dtype == _INT64:
            arr = np.frombuffer(raw, np.int64)
        else:
            return name, None
    elif floats:
        arr = np.asarray(floats, np.float32)
    else:
        return name, None
    return name, arr.reshape(dims) if dims else arr


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """All named weight tensors of an ONNX model."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError("no GraphProto in model")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            if arr is not None:
                out[name] = arr
    return out


def _msc_variables(path: str) -> Dict:
    """A MultiSignalClassifier ``.onnx`` -> its variables in the reference's
    tree. The exporter folds the Linear weights it multiplies into
    ``onnx::MatMul_*`` operands (already x @ W); the biases and the
    attention's projections keep their torch names."""
    w = load_onnx_initializers(path)
    matmuls = sorted((k for k in w if k.startswith("onnx::MatMul")),
                     key=lambda k: int(k.rsplit("_", 1)[1]))
    in_proj_xw, head0_xw, head1_xw = (w[k] for k in matmuls)
    d = in_proj_xw.shape[0]
    b = w["attention.in_proj_bias"]

    def dense(kernel, bias):
        return {"kernel": kernel.copy(), "bias": bias.copy()}

    return {"params": {
        "embed": {
            "Dense_0": dense(w["shared_layer.0.weight"].T,
                             w["shared_layer.0.bias"]),
            "Dense_1": dense(w["shared_layer.2.weight"].T,
                             w["shared_layer.2.bias"]),
        },
        "attn": {
            "q_proj": dense(in_proj_xw[:, :d], b[:d]),
            "k_proj": dense(in_proj_xw[:, d:2 * d], b[d:2 * d]),
            "v_proj": dense(in_proj_xw[:, 2 * d:], b[2 * d:]),
            "out_proj": dense(w["attention.out_proj.weight"].T,
                              w["attention.out_proj.bias"]),
        },
        "head": {
            "Dense_0": dense(head0_xw, w["classifier.0.bias"]),
            "Dense_1": dense(head1_xw, w["classifier.2.bias"]),
        },
    }}


def import_msc_onnx(path: str, num_heads: int = 4,
                    device: Device = None) -> MultiSignalClassifier:
    """The port's ``MultiSignalClassifier`` with the weights of a reference
    ``.onnx`` export, its widths read from the file (the head count is
    not in the weights: the reference's is 4), in eval mode on ``device``
    (default ``"cuda"``)."""
    variables = _msc_variables(path)
    p = variables["params"]
    hidden = (p["embed"]["Dense_0"]["kernel"].shape[1],
              p["embed"]["Dense_1"]["kernel"].shape[1],
              p["head"]["Dense_0"]["kernel"].shape[1])
    model = MultiSignalClassifier(
        hidden, num_heads,
        signal_length=p["embed"]["Dense_0"]["kernel"].shape[0],
        device="cpu")
    return load_jax_variables(model, variables, device).eval()
