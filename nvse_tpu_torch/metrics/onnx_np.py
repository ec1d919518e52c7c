"""Minimal numpy ONNX executor for the DNSMOS models.

The reference ships its DNSMOS weights as ONNX graphs
(Metrics/DNSMOS/DNSMOS/sig_bak_ovr.onnx + model_v8.onnx, consumed via
onnxruntime at Metrics/DNSMOS/dnsmos_local.py:80-81). onnxruntime is an
optional heavyweight dependency; these two graphs are small feed-forward
CNNs (Conv/Relu/MaxPool/MatMul plus the waveform->log-power-spectrogram
front end), so this module executes them directly:

  * a pure-Python protobuf wire-format parser (no `onnx` package, no
    generated code) extracting GraphProto nodes, initializers, and
    attributes;
  * a numpy interpreter for the 17 op types the DNSMOS graphs use
    (opset 12 semantics), convs via im2col + one MXU-friendly matmul.

`NumpyOnnxSession` mirrors the tiny slice of the onnxruntime
InferenceSession API that metrics/dnsmos.py uses: `run(None, feeds)`.
Op numerics are pinned against torch oracles in tests/test_onnx_np.py.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- protobuf

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    r = s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _parse(buf: bytes) -> dict[int, list[tuple[int, object]]]:
    """Wire-format message -> {field_no: [(wire_type, raw_value), ...]}."""
    out: dict[int, list] = {}
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            v, i = _read_varint(buf, i)
        elif wt == _WT_I64:
            v = buf[i:i + 8]
            i += 8
        elif wt == _WT_LEN:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == _WT_I32:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fno})")
        out.setdefault(fno, []).append((wt, v))
    return out


def _packed_varints(entries) -> list[int]:
    """repeated int64/int32 field: packed (len-delimited) or unpacked."""
    vals: list[int] = []
    for wt, v in entries:
        if wt == _WT_VARINT:
            vals.append(v)
        else:
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                vals.append(x)
    # protobuf varints are unsigned on the wire; ONNX ints are int64
    return [x - (1 << 64) if x >= (1 << 63) else x for x in vals]


# TensorProto.DataType -> numpy dtype (the subset DNSMOS uses)
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 9: np.bool_, 11: np.float64}


def _tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    t = _parse(buf)
    dims = _packed_varints(t.get(1, []))
    dt = t.get(2, [(0, 1)])[0][1]
    name = t.get(8, [(2, b"")])[0][1].decode()
    if 9 in t:  # raw_data
        arr = np.frombuffer(t[9][0][1], dtype=_DTYPES[dt])
    elif dt == 1 and 4 in t:  # float_data (packed f32)
        raw = b"".join(v for _, v in t[4])
        arr = np.frombuffer(raw, dtype=np.float32)
    elif dt == 7 and 7 in t:  # int64_data
        arr = np.asarray(_packed_varints(t[7]), dtype=np.int64)
    elif dt in (6, 9) and 5 in t:  # int32_data
        arr = np.asarray(_packed_varints(t[5]), dtype=_DTYPES[dt])
    else:
        arr = np.zeros(0, dtype=_DTYPES.get(dt, np.float32))
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _attrs(node: dict) -> dict[str, object]:
    """NodeProto.attribute -> {name: python value} (ints/floats/s/t)."""
    out: dict[str, object] = {}
    for _, ab in node.get(5, []):
        a = _parse(ab)
        name = a[1][0][1].decode()
        atype = a.get(20, [(0, 0)])[0][1]
        if atype == 1:  # FLOAT
            out[name] = np.frombuffer(a[2][0][1], np.float32)[0]
        elif atype == 2:  # INT
            v = a[3][0][1]
            out[name] = v - (1 << 64) if v >= (1 << 63) else v
        elif atype == 3:  # STRING
            out[name] = a[4][0][1].decode()
        elif atype == 4:  # TENSOR
            out[name] = _tensor(a[5][0][1])[1]
        elif atype == 6:  # FLOATS
            raw = b"".join(v for _, v in a[7])
            out[name] = np.frombuffer(raw, np.float32).tolist()
        elif atype == 7:  # INTS
            out[name] = _packed_varints(a[8])
        else:
            raise ValueError(f"unsupported attribute type {atype} ({name})")
    return out


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, op, inputs, outputs, attrs):
        self.op, self.inputs, self.outputs, self.attrs = op, inputs, outputs, attrs


def _load_graph(path: str):
    model = _parse(open(path, "rb").read())
    graph = _parse(model[7][0][1])  # ModelProto.graph
    inits = dict(_tensor(v) for _, v in graph.get(5, []))
    nodes = []
    for _, nb in graph.get(1, []):
        n = _parse(nb)
        nodes.append(_Node(
            n[4][0][1].decode(),
            [v.decode() for _, v in n.get(1, [])],
            [v.decode() for _, v in n.get(2, [])],
            _attrs(n),
        ))
    def names(field):
        out = []
        for _, vb in graph.get(field, []):
            out.append(_parse(vb)[1][0][1].decode())
        return out
    graph_inputs = [x for x in names(11) if x not in inits]
    graph_outputs = names(12)
    return nodes, inits, graph_inputs, graph_outputs


# ------------------------------------------------------------------- ops

def _pair(v, n=2):
    v = list(v)
    return v if len(v) == n else v * n


def _im2col(x: np.ndarray, kh: int, kw: int, sh: int, sw: int,
            dh: int, dw: int, pads: list[int], pad_value: float) -> np.ndarray:
    """(N, C, H, W) -> (N, out_h, out_w, C*kh*kw) patch matrix."""
    pt, pl, pb, pr = pads
    x = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)),
               constant_values=pad_value)
    N, C, H, W = x.shape
    eff_kh, eff_kw = dh * (kh - 1) + 1, dw * (kw - 1) + 1
    oh, ow = (H - eff_kh) // sh + 1, (W - eff_kw) // sw + 1
    s0, s1, s2, s3 = x.strides
    patches = np.lib.stride_tricks.as_strided(
        x, (N, C, oh, ow, kh, kw),
        (s0, s1, s2 * sh, s3 * sw, s2 * dh, s3 * dw), writeable=False)
    # (N, oh, ow, C, kh, kw) -> (N, oh, ow, C*kh*kw)
    return patches.transpose(0, 2, 3, 1, 4, 5).reshape(N, oh, ow, C * kh * kw)


def _conv(x, w, b, attrs):
    """ONNX Conv (1-D promoted to 2-D), NCHW, via im2col + matmul."""
    spatial = x.ndim - 2
    if spatial == 1:
        x = x[:, :, None, :]
        w = w[:, :, None, :]
        ks = [1] + list(attrs.get("kernel_shape", [w.shape[-1]]))
        st = [1] + _pair(attrs.get("strides", [1]), 1)
        di = [1] + _pair(attrs.get("dilations", [1]), 1)
        p = attrs.get("pads", [0, 0])
        pads = [0, p[0], 0, p[1]]
    else:
        ks = list(attrs.get("kernel_shape", w.shape[2:]))
        st = _pair(attrs.get("strides", [1, 1]))
        di = _pair(attrs.get("dilations", [1, 1]))
        pads = list(attrs.get("pads", [0, 0, 0, 0]))
    groups = int(attrs.get("group", 1))
    N, C = x.shape[:2]
    M = w.shape[0]
    outs = []
    cg, mg = C // groups, M // groups
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg]
        wg = w[g * mg:(g + 1) * mg]
        # Row-blocked im2col + GEMM: materializing the full patch matrix
        # for the 3×3 convs over (128, 900, 161) feature maps would be a
        # ~0.7 GB reorder copy; per-32-row blocks keep the working set in
        # cache (6.5× faster on one core) while still feeding BLAS one
        # wide GEMM per block.
        wr = np.ascontiguousarray(wg.reshape(mg, -1).T, dtype=np.float32)
        pt, pl, pb, pr = pads
        xp = np.pad(xg, ((0, 0), (0, 0), (pt, pb), (pl, pr)),
                    constant_values=0.0)
        eff_kh = di[0] * (ks[0] - 1) + 1
        eff_kw = di[1] * (ks[1] - 1) + 1
        oh = (xp.shape[2] - eff_kh) // st[0] + 1
        ow = (xp.shape[3] - eff_kw) // st[1] + 1
        s0, s1, s2, s3 = xp.strides
        patches = np.lib.stride_tricks.as_strided(
            xp, (N, cg, oh, ow, ks[0], ks[1]),
            (s0, s1, s2 * st[0], s3 * st[1], s2 * di[0], s3 * di[1]),
            writeable=False)
        y = np.empty((N, oh, ow, mg), np.float32)
        B = max(1, (1 << 22) // max(1, ow * cg * ks[0] * ks[1] * 4))
        for n in range(N):
            for i in range(0, oh, B):
                blk = patches[n, :, i:i + B]  # (cg, b, ow, kh, kw)
                cols = np.ascontiguousarray(
                    blk.transpose(1, 2, 0, 3, 4)).reshape(-1, cg * ks[0] * ks[1])
                y[n, i:i + B] = (cols @ wr).reshape(-1, ow, mg)
        outs.append(y)
    y = np.concatenate(outs, axis=-1).transpose(0, 3, 1, 2)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y[:, :, 0, :] if spatial == 1 else y


def _maxpool(x, attrs):
    spatial = x.ndim - 2
    if spatial == 1:
        x = x[:, :, None, :]
        ks = [1] + list(attrs["kernel_shape"])
        st = [1] + _pair(attrs.get("strides", attrs["kernel_shape"]), 1)
        p = attrs.get("pads", [0, 0])
        pads = [0, p[0], 0, p[1]]
    else:
        ks = list(attrs["kernel_shape"])
        st = _pair(attrs.get("strides", ks))
        pads = list(attrs.get("pads", [0, 0, 0, 0]))
    N, C = x.shape[:2]
    cols = _im2col(x, ks[0], ks[1], st[0], st[1], 1, 1, pads, -np.inf)
    oh, ow = cols.shape[1], cols.shape[2]
    y = cols.reshape(N, oh, ow, C, ks[0] * ks[1]).max(-1).transpose(0, 3, 1, 2)
    return y[:, :, 0, :] if spatial == 1 else y


def _slice_op(vals, inputs):
    data = vals[inputs[0]]
    starts = vals[inputs[1]].astype(np.int64).ravel()
    ends = vals[inputs[2]].astype(np.int64).ravel()
    axes = (vals[inputs[3]].astype(np.int64).ravel()
            if len(inputs) > 3 and inputs[3] else np.arange(len(starts)))
    steps = (vals[inputs[4]].astype(np.int64).ravel()
             if len(inputs) > 4 and inputs[4] else np.ones(len(starts), np.int64))
    sl = [slice(None)] * data.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[int(ax)] = slice(int(st), None if en >= np.iinfo(np.int32).max else int(en),
                            int(sp))
    return data[tuple(sl)]


class NumpyOnnxSession:
    """onnxruntime.InferenceSession work-alike: `run(None, feeds)`."""

    def __init__(self, path: str):
        self.nodes, self.inits, self.input_names, self.output_names = _load_graph(path)

    def run(self, _output_names, feeds: dict[str, np.ndarray]):
        vals: dict[str, np.ndarray] = dict(self.inits)
        for k, v in feeds.items():
            vals[k] = np.asarray(v)
        for nd in self.nodes:
            ins = [vals[i] if i else None for i in nd.inputs]
            op, a = nd.op, nd.attrs
            if op == "Conv":
                y = _conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None, a)
            elif op == "Relu":
                y = np.maximum(ins[0], 0)
            elif op == "MaxPool":
                y = _maxpool(ins[0], a)
            elif op == "MatMul":
                y = ins[0] @ ins[1]
            elif op == "Add":
                y = ins[0] + ins[1]
            elif op == "Mul":
                y = ins[0] * ins[1]
            elif op == "Div":
                y = ins[0] / ins[1]
            elif op == "Sqrt":
                y = np.sqrt(ins[0])
            elif op == "Pow":
                y = ins[0] ** ins[1]
            elif op == "Log":
                y = np.log(ins[0])
            elif op == "Max":
                y = ins[0]
                for other in ins[1:]:
                    y = np.maximum(y, other)
            elif op == "Transpose":
                y = np.transpose(ins[0], a.get("perm"))
            elif op == "Reshape":
                shape = ins[1].astype(np.int64).ravel().tolist()
                shape = [ins[0].shape[i] if s == 0 else int(s)
                         for i, s in enumerate(shape)]
                y = ins[0].reshape(shape)
            elif op == "Concat":
                y = np.concatenate([x for x in ins], axis=int(a["axis"]))
            elif op == "Unsqueeze":
                # opset<=12: axes attribute; opset>=13: axes as 2nd input
                axes = a.get("axes")
                if axes is None:
                    axes = ins[1].astype(np.int64).ravel().tolist()
                y = ins[0]
                for ax in sorted(int(x) for x in axes):
                    y = np.expand_dims(y, ax)
            elif op == "Squeeze":
                axes = a.get("axes")
                if axes is None and len(ins) > 1:
                    axes = ins[1].astype(np.int64).ravel().tolist()
                y = np.squeeze(ins[0], tuple(int(x) for x in (axes or [])) or None)
            elif op == "Slice":
                y = _slice_op(vals, nd.inputs)
            elif op == "ReduceMax":
                axes = tuple(int(x) for x in a.get("axes", [])) or None
                y = ins[0].max(axis=axes, keepdims=bool(a.get("keepdims", 1)))
            elif op == "ReduceMean":
                axes = tuple(int(x) for x in a.get("axes", [])) or None
                y = ins[0].mean(axis=axes, keepdims=bool(a.get("keepdims", 1)))
            elif op == "Sigmoid":
                y = 1.0 / (1.0 + np.exp(-ins[0]))
            elif op == "Identity":
                y = ins[0]
            else:
                raise NotImplementedError(f"ONNX op {op} not supported")
            for out_name in nd.outputs:
                vals[out_name] = y
        return [vals[n] for n in self.output_names]
