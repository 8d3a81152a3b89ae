"""Weights from outside the framework, and the reference's file formats.

Counterpart of ``mxnet_tpu/interop.py``. Two parts:

* the reference's formats: binary ``.params`` files and legacy symbol
  JSON (below);
* the port's own helpers: :func:`params_from_numpy` for the predictor
  and the server, :func:`module_params_from_numpy` for
  ``Module.init_params`` / ``set_params`` (a ``FusedRNNCell``'s packed
  vector among them, under its name), and :func:`load_block_params` /
  :func:`block_params_to_numpy` to carry a gluon net's weights across,
  both ways, between the JAX package's net and the port's (the two
  ``collect_params()`` name the same parameters alike; a
  ``SymbolBlock``'s names are its graph's; a ``gluon.rnn`` layer's or
  cell's per-layer names are the JAX package's).

The reference serializes NDArray maps as a dmlc stream container
(``src/ndarray/ndarray.cc:1767-1795``): a ``uint64`` list magic ``0x112``,
a ``uint64`` reserved word, a ``uint64``-counted vector of NDArray
records, then a ``uint64``-counted vector of names (each ``uint64`` length
+ bytes). Each record (``NDArray::Save``, ``ndarray.cc:1567-1633``) is:

- ``uint32`` magic: ``0xF993fac9`` (V2, with storage type),
  ``0xF993fac8`` (V1, int64 shape, dense only), or, before V1, the raw
  ``ndim`` with ``uint32`` dims following (``LegacyTShapeLoad``);
- V2 only: ``int32`` storage type (0 dense / 1 row_sparse / 2 csr) and,
  for sparse, the storage shape;
- shape (``uint32`` ndim + ``int64`` dims), an empty shape meaning none;
- context (``int32`` dev_type, ``int32`` dev_id);
- ``int32`` mshadow type flag; the sparse aux types and shapes; the raw
  little-endian buffer(s): row_sparse aux = [indices], csr aux =
  [indptr, indices].

The writer writes dense V2 records only: a sparse array is written
densified, and a dtype without a type flag (bfloat16 among them) raises.
The loaders here put the arrays on the host, as ``model.load_params``
places a checkpoint; ``mx.nd.load(fname, ctx=...)`` reads the same files
onto a context.

Symbol JSON import takes the nnvm graph format with the legacy upgrades
of ``src/nnvm/legacy_json_util.cc``: per-node attrs under ``attrs``/
``attr``/``param``, 2- or 3-element input and head entries, hidden
``lr_mult``-style keys rehomed onto variables
(``UpgradeJSON_FixParsing``), pre-0.9 missing aux inputs re-created
(``UpgradeJSON_000800_000900``), and the argmin/argmax ``axis=-1`` drop
(``UpgradeJSON_000904_000905``). A variable's attributes go to its
attribute dict as strings (``Symbol.attr``), as the port's ``Variable``
keeps them.
"""
from __future__ import annotations

import ast
import json
import logging
import struct
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["params_from_numpy", "module_params_from_numpy",
           "load_block_params", "block_params_to_numpy",
           "load_reference_params", "save_reference_params",
           "load_reference_ndarrays", "save_reference_ndarrays",
           "symbol_from_reference_json", "load_reference_checkpoint",
           "is_reference_params_file", "is_reference_symbol_json"]

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

# mshadow type flags (reference 3rdparty/mshadow/mshadow/base.h TypeFlag)
_FLAG_TO_DTYPE = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                  4: "int32", 5: "int8", 6: "int64"}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}

_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2


class _Reader:
    def __init__(self, data: bytes):
        self._b = memoryview(data)
        self._pos = 0

    def read(self, n: int) -> memoryview:
        if self._pos + n > len(self._b):
            raise MXNetError("reference .params file truncated at byte "
                             f"{self._pos} (wanted {n} more)")
        out = self._b[self._pos:self._pos + n]
        self._pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]


def _read_shape_v2(r: _Reader) -> Tuple[int, ...]:
    ndim = r.u32()
    return tuple(struct.unpack(f"<{ndim}q", r.read(8 * ndim)))


def _read_shape_legacy(r: _Reader, ndim: int) -> Tuple[int, ...]:
    return tuple(struct.unpack(f"<{ndim}I", r.read(4 * ndim)))


def _read_buffer(r: _Reader, shape, dtype) -> np.ndarray:
    count = int(np.prod(shape)) if shape else 1
    nbytes = count * np.dtype(dtype).itemsize
    # a read-only view of the file's bytes: the arrays made from it copy
    return np.frombuffer(r.read(nbytes), dtype=dtype).reshape(shape)


def _read_record(r: _Reader):
    """One NDArray record -> numpy array | (stype, shape, data, aux) |
    None."""
    magic = r.u32()
    if magic == _V2_MAGIC:
        stype = r.i32()
        nad = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1,
               _STYPE_CSR: 2}.get(stype)
        if nad is None:
            raise MXNetError(f"reference .params: unknown storage type "
                             f"{stype}")
        sshape = _read_shape_v2(r) if nad else None
        shape = _read_shape_v2(r)
        if len(shape) == 0:
            return None
        r.i32(); r.i32()  # context (dev_type, dev_id): not kept
        dtype = _FLAG_TO_DTYPE[r.i32()]
        aux = []
        for _ in range(nad):
            aux_dtype = _FLAG_TO_DTYPE[r.i32()]
            aux.append((aux_dtype, _read_shape_v2(r)))
        data = _read_buffer(r, sshape if nad else shape, dtype)
        aux_data = [_read_buffer(r, s, dt) for dt, s in aux]
        if stype == _STYPE_DEFAULT:
            return data
        return (stype, shape, data, aux_data)
    if magic == _V1_MAGIC:
        shape = _read_shape_v2(r)
    else:
        # before V1 the "magic" is the ndim, and uint32 dims follow
        shape = _read_shape_legacy(r, magic)
    if len(shape) == 0:
        return None
    r.i32(); r.i32()  # context
    dtype = _FLAG_TO_DTYPE[r.i32()]
    return _read_buffer(r, shape, dtype)


def is_reference_params_file(fname: str) -> bool:
    try:
        with open(fname, "rb") as f:
            head = f.read(8)
    except OSError:
        return False
    return _is_reference_head(head)


def _is_reference_head(head: bytes) -> bool:
    return len(head) == 8 and struct.unpack("<Q", head)[0] == _LIST_MAGIC


def _ndarrays_from_bytes(data: bytes, label: str, ctx):
    """(arrays, names) of a reference NDArray list file's bytes, the
    arrays on ``ctx``: NDArrays, or sparse NDArrays for sparse records."""
    from .ndarray import sparse as _sparse
    r = _Reader(data)
    if r.u64() != _LIST_MAGIC:
        raise MXNetError(f"{label}: not a reference NDArray file")
    r.u64()  # reserved
    raw = [_read_record(r) for _ in range(r.u64())]
    names = [bytes(r.read(r.u64())).decode() for _ in range(r.u64())]
    if names and len(names) != len(raw):
        raise MXNetError(f"{label}: {len(names)} names for {len(raw)} "
                         f"arrays")
    out = []
    for rec in raw:
        if rec is None:
            out.append(None)
        elif isinstance(rec, tuple):
            stype, shape, data, aux = rec
            if stype == _STYPE_ROW_SPARSE:
                out.append(_sparse.row_sparse_array(
                    (data, aux[0]), shape=shape, ctx=ctx))
            else:  # csr: aux = [indptr, indices]
                out.append(_sparse.csr_matrix(
                    (data, aux[1], aux[0]), shape=shape, ctx=ctx))
        else:
            # the dtype on disk is kept (``array`` alone would make
            # float64 float32, as the reference's frontend does)
            out.append(array(rec, ctx=ctx, dtype=rec.dtype))
    return out, names


def load_reference_ndarrays(fname: str):
    """A reference NDArray list file -> (list of arrays on the host,
    names); ``names`` is ``[]`` when the file stores an unnamed list."""
    with open(fname, "rb") as f:
        return _ndarrays_from_bytes(f.read(), fname, cpu())


def load_reference_params(fname: str) -> Dict[str, object]:
    """A reference ``.params`` file as a name -> array dict. Keys keep
    their ``arg:``/``aux:`` prefixes where present (the reference's
    ``save_checkpoint`` writes them, ``python/mxnet/model.py:388``); an
    unnamed list gets the keys ``ndarray_{i}``."""
    arrays, names = load_reference_ndarrays(fname)
    if not names:
        names = [f"ndarray_{i}" for i in range(len(arrays))]
    return dict(zip(names, arrays))


def _write_shape(out, shape) -> None:
    out.write(struct.pack("<I", len(shape)))
    out.write(struct.pack(f"<{len(shape)}q", *shape))


def _write_record(out, arr) -> None:
    """One dense V2 record: a sparse array densified; a dtype without a
    type flag (bfloat16 among them) raises, before any copy."""
    from .ndarray.sparse import BaseSparseNDArray
    if isinstance(arr, BaseSparseNDArray):
        arr = arr.todense()
    t = arr._data if isinstance(arr, NDArray) else arr
    if isinstance(t, torch.Tensor):
        dt = str(t.dtype).replace("torch.", "")
        if dt not in _DTYPE_TO_FLAG:
            raise MXNetError(f"dtype {dt} has no reference type flag; cast "
                             f"first")
        t = t.detach().cpu().numpy()
    np_a = np.ascontiguousarray(t)
    dt = str(np_a.dtype)
    if dt not in _DTYPE_TO_FLAG:
        raise MXNetError(f"dtype {dt} has no reference type flag; cast first")
    out.write(struct.pack("<Ii", _V2_MAGIC, _STYPE_DEFAULT))
    _write_shape(out, np_a.shape)
    out.write(struct.pack("<iii", 1, 0, _DTYPE_TO_FLAG[dt]))  # cpu(0), type
    out.write(np_a.reshape(-1).view(np.uint8).data)


def save_reference_ndarrays(fname: str, arrays: List,
                            names: List[str]) -> None:
    """Write a reference NDArray list file (dense V2 records)."""
    with open(fname, "wb") as out:
        out.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for a in arrays:
            _write_record(out, a)
        out.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode()
            out.write(struct.pack("<Q", len(b)))
            out.write(b)


def save_reference_params(fname: str, params: Dict[str, object]) -> None:
    """Write a dict of arrays in the reference's ``.params`` format, for
    the reference's own tools to read."""
    names = list(params.keys())
    save_reference_ndarrays(fname, [params[k] for k in names], names)


# --------------------------------------------------------------------------
# symbol JSON with the legacy upgrades
# --------------------------------------------------------------------------
# attrs the reference parks on nodes that belong to variables or to the
# schedule, not to the op (kHiddenKeys, src/c_api/c_api_common.h)
_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring")

# pre-0.9 JSON dropped the aux-state inputs: re-created per op, in the
# reference's input order (UpgradeJSON_000800_000900 + FListInputNames)
_AUX_INPUT_NAMES = {
    "BatchNorm": ("moving_mean", "moving_var"),
    "CuDNNBatchNorm": ("moving_mean", "moving_var"),
}


def _parse_attr_value(s):
    """The reference's attr values are strings ('(3, 3)', '64', 'True',
    'relu')."""
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s.strip())
    except (ValueError, SyntaxError):
        return s


def is_reference_symbol_json(data: dict) -> bool:
    return "mxnet_tpu_version" not in data and "nodes" in data


def symbol_from_reference_json(json_str_or_dict: Union[str, dict]):
    """A Symbol from the reference's (nnvm) graph JSON, through the legacy
    upgrade chain, so 0.8-era files load too."""
    from .symbol.symbol import Symbol, _Node

    data = (json.loads(json_str_or_dict)
            if isinstance(json_str_or_dict, str) else json_str_or_dict)
    jnodes = data.get("nodes")
    if jnodes is None:
        raise MXNetError("symbol JSON has no 'nodes' list")

    version = 0
    gattrs = data.get("attrs", {})
    if isinstance(gattrs, dict) and "mxnet_version" in gattrs:
        v = gattrs["mxnet_version"]
        version = v[1] if isinstance(v, (list, tuple)) else v

    nodes: List = []
    for jn in jnodes:
        op = None if jn.get("op", "null") in (None, "null") else jn["op"]
        # the attrs key by era: attrs (>= 1.0), attr (0.9.x), param (0.8)
        raw_attrs = dict(jn.get("attrs") or jn.get("attr")
                         or jn.get("param") or {})
        attrs, meta, hidden = {}, {}, {}
        for k, v in raw_attrs.items():
            base = k[2:-2] if k.startswith("__") and k.endswith("__") else k
            if base in _HIDDEN_KEYS or any(
                    k.endswith("_" + h) for h in _HIDDEN_KEYS):
                hidden[k] = v
            elif op is None:
                meta[k if k.startswith("__") else f"__{k}__"] = v
            else:
                attrs[k] = _parse_attr_value(v)
        inputs = [(nodes[e[0]], e[1]) for e in jn.get("inputs", [])]
        node = _Node(op, jn.get("name", ""), attrs, inputs)
        node._attr_dict.update(meta)
        nodes.append(node)
        # rehome hidden keys: a bare key on a variable stays on it; an
        # 'argname_lr_mult' on an op node moves onto the matching variable
        # input where there is one
        for k, v in hidden.items():
            if op is None:
                node._attr_dict[f"__{k.strip('_')}__"] = v
                continue
            for h in _HIDDEN_KEYS:
                if not k.endswith("_" + h):
                    continue
                arg = k[:-(len(h) + 1)]
                for src, _ in node.inputs:
                    if src.op is None and (src.name == arg
                                           or src.name.endswith("_" + arg)):
                        src._attr_dict[f"__{h}__"] = v
                        break
                break

        # UpgradeJSON_000800_000900: re-create the dropped aux inputs. The
        # new variables are inputs only: ``nodes`` mirrors the JSON's ids
        if op in _AUX_INPUT_NAMES and version < 900:
            want = _AUX_INPUT_NAMES[op]
            missing = [n for n in want
                       if not any(s.name.endswith(n) for s, _ in node.inputs)]
            for aux_name in missing:
                node.inputs.append(
                    (_Node(None, f"{node.name}_{aux_name}", {}, []), 0))

        # UpgradeJSON_000904_000905: argmin/argmax's optional axis
        if op in ("argmin", "argmax") and version < 905 \
                and attrs.get("axis") == -1:
            attrs.pop("axis")

    heads_raw = data.get("heads") or [[len(nodes) - 1, 0]]
    heads = [(nodes[h[0]], h[1] if len(h) > 1 else 0) for h in heads_raw]
    if version and version < 10000:
        logging.getLogger(__name__).info(
            "loaded symbol saved by reference v%d.%d.%d (upgraded)",
            version // 10000, (version // 100) % 100, version % 100)
    return Symbol(heads)


def load_reference_checkpoint(prefix: str, epoch: int):
    """The reference's checkpoint pair -> (symbol, arg_params,
    aux_params), the arrays on the host; a key without an ``arg:``/
    ``aux:`` prefix is an argument."""
    from .symbol import load as sym_load
    symbol = sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in load_reference_params(f"{prefix}-{epoch:04d}.params").items():
        tp, _, name = k.partition(":")
        if tp == "aux":
            aux_params[name] = v
        else:
            arg_params[name if tp == "arg" else k] = v
    return symbol, arg_params, aux_params


# --------------------------------------------------------------------------
# the port's own helpers
# --------------------------------------------------------------------------
def params_from_numpy(arrays: Dict[str, np.ndarray],
                      ctx) -> Dict[str, NDArray]:
    """numpy arrays -> NDArrays on ``ctx``, keys unchanged: ``arg:``/
    ``aux:`` prefixes are kept, so the result can stand where a ``.params``
    file's bytes would (e.g. ``ModelConfig(param_bytes=...)``)."""
    return {str(k): array(np.asarray(v), ctx=ctx) for k, v in arrays.items()}


def module_params_from_numpy(arrays: Dict[str, np.ndarray], ctx):
    """(arg_params, aux_params) of NDArrays on ``ctx`` from numpy arrays
    keyed as a checkpoint keys them (``arg:name``, ``aux:name``): what
    ``model.load_checkpoint`` of the same values would give."""
    out = ({}, {})
    for k, v in arrays.items():
        tp, _, name = str(k).partition(":")
        if tp not in ("arg", "aux") or not name:
            raise MXNetError(f"module_params_from_numpy: key {k!r} is not "
                             f"'arg:name' or 'aux:name'")
        out[tp == "aux"][name] = array(np.asarray(v), ctx=ctx)
    return out


def load_block_params(net, arrays: Dict[str, np.ndarray]) -> None:
    """Set every parameter of ``net`` from ``arrays``, keyed by the full
    parameter name (as ``collect_params()`` of the JAX package's twin net
    gives them); the key sets must be equal."""
    params = net.collect_params()
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"load_block_params: names differ; missing "
                         f"{missing[:5]}, extra {extra[:5]}")
    for name, p in params.items():
        p.set_data(np.asarray(arrays[name]))


def block_params_to_numpy(net) -> Dict[str, np.ndarray]:
    """{full parameter name: numpy array} of ``net``'s current values."""
    return {name: p.data().asnumpy()
            for name, p in net.collect_params().items()}
