"""Graph-pass manager: rewrites over Symbol graphs.

Counterpart of ``mxnet_tpu/passes/manager.py``. A :class:`PassManager` is
an ordered pipeline of :class:`Pass` instances; ``Module`` and
``DataParallelTrainer`` run the default pipeline on every graph they bind
unless constructed with ``passes=False``.

Pipeline semantics, as in the JAX package:

* passes run in order over a functional rebuild of the node DAG: the
  input Symbol is never mutated, and a pass that rewrites nothing returns
  the input symbol object itself;
* a pass may re-home a variable (give it another layout or shape, an OIHW
  conv weight becoming OHWI) instead of inserting transposes; each
  re-homing is recorded in the :class:`PassResult` as a value transform,
  which the trainer applies to the parameter's value at capture and
  inverts in ``sync_to_net``, so the user's net keeps its own layout;
* ``MXNET_PASSES`` selects the default pipeline: ``"0"``/``"off"`` turns it
  off, ``"layout,fusion"`` runs exactly those passes, ``"-s2d"`` the
  default set less one.

Passes: ``fold`` (constant folding, dead-branch elimination), ``layout``
(NCHW→NHWC propagation), ``s2d`` (the space-to-depth stem), ``fusion``
(transpose reordering), and the opt-in ``quantize``/``requantize``/
``dequantize`` of :mod:`mxnet_tpu_torch.quant`.

Where the JAX package annotates a graph with ``jax.eval_shape``, the port
runs each op on ``meta`` tensors (:func:`annotate_graph`), as tolerant:
an entry whose inference fails is ``None`` and the passes skip it.
"""
from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, get_env, logger, register_config

__all__ = ["Pass", "PassContext", "PassResult", "PassManager",
           "DEFAULT_PIPELINE", "PASS_REGISTRY", "register_pass",
           "default_names", "resolve", "annotate_graph", "apply_spec",
           "spec_shape", "provenance", "s2d_weight_forward",
           "s2d_weight_inverse", "Namer", "is_barrier"]

register_config(
    "MXNET_PASSES", "", str,
    "Default graph-pass pipeline for Module/DataParallelTrainer capture. "
    "Empty = the built-in default (fold,layout,s2d,fusion); '0'/'off' "
    "disables it; 'layout,fusion' runs exactly those; '-s2d' runs the "
    "default minus a pass.")

#: canonical order; also the default pipeline
DEFAULT_PIPELINE = ("fold", "layout", "s2d", "fusion")

#: name -> Pass subclass (filled by the pass modules at import)
PASS_REGISTRY: Dict[str, type] = {}


def register_pass(cls) -> type:
    PASS_REGISTRY[cls.name] = cls
    return cls


class Pass:
    """One rewrite pass over a Symbol graph: ``apply(sym, ctx) ->
    (new_sym, rewrite_count)``, functional (the input symbol unchanged
    when nothing rewrites, existing nodes never mutated)."""

    name = "pass"

    def apply(self, sym, ctx: "PassContext"):
        raise NotImplementedError

    def __repr__(self):
        return f"<Pass {self.name}>"


# --------------------------------------------------------------------------
# shared graph utilities
# --------------------------------------------------------------------------

_NCHW_SPELLINGS = (None, "None", "", "NCHW")
_SUBGRAPH_KEYS = ("subgraph_id", "then_id", "else_id", "cond_id", "body_id")


class Namer:
    """Unique names for pass-inserted nodes, seeded with every node name of
    the graph."""

    def __init__(self, sym):
        self._taken = {n.name for n in sym.topo_nodes()}

    def fresh(self, base: str) -> str:
        name, i = base, 0
        while name in self._taken:
            i += 1
            name = f"{base}{i}"
        self._taken.add(name)
        return name


def is_barrier(node) -> bool:
    """Ops that own nested subgraphs: passes leave them as they are."""
    if node.op is None:
        return False
    if node.op == "_subgraph":
        return True
    return any(k in (node.attrs or {}) for k in _SUBGRAPH_KEYS)


def _parse_shape_attr(v: str) -> Optional[Tuple[int, ...]]:
    try:
        return tuple(int(x) for x in ast.literal_eval(v))
    except (ValueError, SyntaxError, TypeError):
        return None


def _parse_dtype_attr(v: str):
    """``__dtype__`` attributes are ``str(dtype)``: 'float64',
    "<class 'numpy.float64'>", 'np.float64' and the like."""
    try:
        return np.dtype(v)
    except TypeError:
        pass
    for name in ("float64", "bfloat16", "float32", "float16", "uint64",
                 "uint32", "uint16", "uint8", "int64", "int32", "int16",
                 "int8", "bool"):
        if name in str(v):
            return name
    return None


def _torch_dtype(dt):
    from ..ndarray.ndarray import torch_dtype
    try:
        return torch_dtype(dt)
    except (MXNetError, TypeError):
        return torch.float32


def annotate_graph(sym, shapes: Optional[Dict[str, Sequence[int]]] = None,
                   dtypes: Optional[Dict[str, Any]] = None
                   ) -> Dict[Tuple[int, int], Any]:
    """Tolerant abstract evaluation: every graph entry ``(id(node),
    out_idx)`` -> a ``meta`` tensor of its shape and dtype, or ``None``
    where inference fails (passes skip nodes with unknown inputs).
    Variables are keyed ``(id(var), 0)``; the executor's parameter-shape
    rules fill in weight shapes from data shapes."""
    from .._imperative import _op_signature_flags
    from ..executor import _PARAM_SHAPE_RULES
    from ..ops.registry import get_op

    shapes = {k: tuple(v) for k, v in (shapes or {}).items()}
    dtypes = dict(dtypes or {})
    var_shape: Dict[str, Tuple[int, ...]] = {}
    var_dtype: Dict[str, torch.dtype] = {}
    nodes = sym.topo_nodes()
    for n in nodes:
        if not n.is_var:
            continue
        s = shapes.get(n.name)
        if s is None and "__shape__" in n._attr_dict:
            s = _parse_shape_attr(n._attr_dict["__shape__"])
        if s is not None:
            var_shape[n.name] = tuple(s)
        dt = dtypes.get(n.name)
        if dt is None and "__dtype__" in n._attr_dict:
            dt = _parse_dtype_attr(n._attr_dict["__dtype__"])
        if dt is not None:
            var_dtype[n.name] = _torch_dtype(dt)

    meta = torch.device("meta")

    def var_aval(name):
        return torch.empty(var_shape[name], device=meta,
                           dtype=var_dtype.get(name, torch.float32))

    avals: Dict[Tuple[int, int], Any] = {}
    for node in nodes:
        if node.is_var:
            avals[(id(node), 0)] = var_aval(node.name) \
                if node.name in var_shape else None
            continue
        try:
            opdef = get_op(node.op)
        except MXNetError:
            continue
        if opdef.host:
            continue
        arg_names = opdef.arg_names() or []
        rule = _PARAM_SHAPE_RULES.get(node.op)
        if rule is not None and node.inputs:
            src0, idx0 = node.inputs[0]
            if src0.is_var:
                ds = var_shape.get(src0.name)
            else:
                av0 = avals.get((id(src0), idx0))
                ds = tuple(av0.shape) if av0 is not None else None
            if ds is not None:
                try:
                    param_shapes = rule(dict(node.attrs), tuple(ds))
                except Exception:
                    param_shapes = {}
                for i, (src, _) in enumerate(node.inputs):
                    if src.is_var and src.name not in var_shape \
                            and i < len(arg_names) \
                            and arg_names[i] in param_shapes:
                        var_shape[src.name] = tuple(
                            param_shapes[arg_names[i]])
                        avals[(id(src), 0)] = var_aval(src.name)
        in_avals = []
        for (src, idx) in node.inputs:
            av = avals.get((id(src), idx))
            if av is None:
                break
            in_avals.append(av)
        else:
            attrs = dict(node.attrs)
            accepts_train, accepts_rng, accepts_device = \
                _op_signature_flags(opdef)
            if accepts_train and "is_train" not in attrs:
                attrs["is_train"] = True
            if accepts_rng:
                attrs["rng"] = None
            if accepts_device and not in_avals:
                attrs["device"] = meta
            try:
                out = opdef.fn(*in_avals, **attrs)
            except Exception:
                continue
            for i, av in enumerate(out if isinstance(out, tuple)
                                   else (out,)):
                avals[(id(node), i)] = av if isinstance(av, torch.Tensor) \
                    else None
    return avals


# --------------------------------------------------------------------------
# value transforms (re-homed variables)
# --------------------------------------------------------------------------

def _inv_perm(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def _is_tensor(value):
    """The transforms below take a numpy array or a tensor (which stays on
    its device)."""
    return isinstance(value, torch.Tensor)


def _zeros(value, shape):
    if _is_tensor(value):
        return torch.zeros(shape, dtype=value.dtype, device=value.device)
    return np.zeros(shape, value.dtype)


def _permute(value, perm):
    return value.permute(*perm) if _is_tensor(value) else np.transpose(value, perm)


def s2d_weight_forward(w):
    """(O,kh,kw,C) OHWI conv weight -> its block-2 space-to-depth twin
    (O,⌈kh/2⌉,⌈kw/2⌉,4C): W'[o,du,dv,(2r+s)C+c] = W[o,2du+r,2dv+s,c],
    zero where the source index falls past the kernel. A numpy array or a
    tensor (which stays on its device)."""
    O, kh, kw, C = w.shape
    kh2, kw2 = (kh + 1) // 2, (kw + 1) // 2
    padded = _zeros(w, (O, 2 * kh2, 2 * kw2, C))
    padded[:, :kh, :kw, :] = w
    return _permute(padded.reshape(O, kh2, 2, kw2, 2, C),
                    (0, 1, 3, 2, 4, 5)).reshape(O, kh2, kw2, 4 * C)


def s2d_weight_inverse(w2, kh: int, kw: int):
    O, kh2, kw2, c4 = w2.shape
    C = c4 // 4
    padded = _permute(w2.reshape(O, kh2, kw2, 2, 2, C),
                      (0, 1, 3, 2, 4, 5)).reshape(O, 2 * kh2, 2 * kw2, C)
    out = padded[:, :kh, :kw, :]
    return out.contiguous() if _is_tensor(out) else np.ascontiguousarray(out)


def apply_spec(spec, value, inverse: bool = False):
    kind = spec[0]
    if kind == "transpose":
        perm = spec[1]
        return _permute(value, _inv_perm(perm) if inverse else perm)
    if kind == "s2d_weight":
        kh, kw = spec[1], spec[2]
        return s2d_weight_inverse(value, kh, kw) if inverse \
            else s2d_weight_forward(value)
    raise MXNetError(f"unknown variable-transform spec {spec!r}")


def spec_shape(spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape ``apply_spec(spec, ·)`` gives, without a value."""
    shape = tuple(int(d) for d in shape)
    kind = spec[0]
    if kind == "transpose":
        return tuple(shape[i] for i in spec[1])
    if kind == "s2d_weight":
        kh, kw = spec[1], spec[2]
        O, _, _, C = shape
        return (O, (kh + 1) // 2, (kw + 1) // 2, 4 * C)
    raise MXNetError(f"unknown variable-transform spec {spec!r}")


def rehomed_shapes(shapes: Dict[str, Sequence[int]],
                   var_transforms: Dict[str, List[tuple]],
                   input_layouts: Dict[str, str]) -> Dict[str, Tuple]:
    """Original variable shapes -> the shapes the rewritten graph
    declares: value transforms through :func:`spec_shape`, NHWC re-homed
    rank-4 inputs permuted."""
    out = {k: tuple(int(d) for d in v) for k, v in shapes.items()}
    for name, specs in var_transforms.items():
        if name in out:
            s = out[name]
            for spec in specs:
                s = spec_shape(spec, s)
            out[name] = s
    for name, lay in input_layouts.items():
        s = out.get(name)
        if lay == "NHWC" and s is not None and len(s) == 4:
            out[name] = (s[0], s[2], s[3], s[1])
    return out


def provenance(manager: Optional["PassManager"],
               result: Optional["PassResult"],
               fallback_rewrites: Optional[Dict[str, int]] = None
               ) -> Dict[str, Any]:
    """The ``passes=`` provenance dict, one schema for the trainer and
    ``Module``."""
    if manager is None:
        return {"enabled": False, "pipeline": [], "applied": []}
    prov: Dict[str, Any] = {"enabled": True,
                            "pipeline": list(manager.names)}
    if manager.input_layout:
        prov["input_layout"] = manager.input_layout
    if result is not None:
        prov["applied"] = result.applied
        prov["rewrites"] = {k: v for k, v in result.counts.items() if v}
    else:
        prov["applied"] = []
        if fallback_rewrites:
            prov["rewrites"] = {k: v for k, v in fallback_rewrites.items()
                                if v}
    return prov


# --------------------------------------------------------------------------
# context / result / manager
# --------------------------------------------------------------------------

class PassContext:
    """State of one pipeline run shared by its passes: known shapes,
    inputs against parameters, the re-homing policy, and the variable
    transforms so far."""

    def __init__(self, shapes=None, dtypes=None, input_vars: Sequence[str] = (),
                 param_names: Optional[Sequence[str]] = None,
                 rehome_params: bool = False,
                 input_layout: Optional[str] = None):
        self.shapes = dict(shapes or {})
        self.dtypes = dict(dtypes or {})
        self.input_vars = set(input_vars or ())
        self.param_names = set(param_names) if param_names is not None \
            else None
        self.rehome_params = bool(rehome_params)
        # "NHWC": the caller feeds channel-last batches, so the layout
        # pass may re-home rank-4 input variables
        self.input_layout = input_layout
        #: var name -> transform specs, applied left to right to the
        #: ORIGINAL value give the rewritten graph's value
        self.var_transforms: Dict[str, List[tuple]] = {}
        #: NEW variables a pass introduced, each with the spec that derives
        #: its value from the original parameters (the quantize pass's int8
        #: weights and range scalars); see PassResult.materialize_params
        self.synth_params: Dict[str, tuple] = {}
        #: internal sources synthesized specs may read (a zero bias)
        self.synth_sources: Dict[str, tuple] = {}
        #: var name -> declared layout after re-homing (inputs only)
        self.input_layouts: Dict[str, str] = {}
        self.counts: Dict[str, int] = {}
        self._aval_cache: Dict[int, Dict] = {}
        self._aval_keep: List[Any] = []   # pin cached symbols (id reuse)

    def can_rehome_param(self, name: str) -> bool:
        if not self.rehome_params or name in self.input_vars:
            return False
        return self.param_names is not None and name in self.param_names

    def can_rehome_input(self, name: str) -> bool:
        return self.input_layout == "NHWC" and name in self.input_vars

    def add_var_transform(self, name: str, spec: tuple) -> None:
        self.var_transforms.setdefault(name, []).append(spec)

    def add_synth_param(self, name: str, spec: tuple) -> None:
        """A NEW variable of the rewritten graph, derived from the original
        parameters: ``("const", value)`` a scalar, ``("quant_of", src,
        part)`` one leg of parameter ``src``'s int8 (quantized/min/max)
        triple."""
        self.synth_params[name] = tuple(spec)

    def add_synth_source(self, name: str, spec: tuple) -> None:
        """An internal source (``("zeros", shape)``) that ``quant_of``
        specs may read; not a graph variable itself."""
        self.synth_sources[name] = tuple(spec)

    def annotate(self, sym) -> Dict[Tuple[int, int], Any]:
        key = id(sym)
        if key not in self._aval_cache:
            shapes = rehomed_shapes(self.shapes, self.var_transforms,
                                    self.input_layouts)
            self._aval_cache[key] = annotate_graph(sym, shapes, self.dtypes)
            self._aval_keep.append(sym)
        return self._aval_cache[key]


class PassResult:
    """What a pipeline run made: the rewritten symbol, the rewrite counts
    by pass, and the variable transforms the caller applies."""

    def __init__(self, symbol, ctx: PassContext, names: Sequence[str]):
        self.symbol = symbol
        self.counts = dict(ctx.counts)
        self.var_transforms = {k: list(v)
                               for k, v in ctx.var_transforms.items()}
        self.input_layouts = dict(ctx.input_layouts)
        self.synth_params = dict(ctx.synth_params)
        self.synth_sources = dict(ctx.synth_sources)
        self.names = tuple(names)

    @property
    def total_rewrites(self) -> int:
        return sum(self.counts.values())

    @property
    def applied(self) -> List[str]:
        """The passes that rewrote something."""
        return [n for n in self.names if self.counts.get(n)]

    def transform_var(self, name: str, value):
        """A variable's value (numpy array or tensor) in the rewritten
        graph's layout."""
        v = value if isinstance(value, torch.Tensor) else np.asarray(value)
        for spec in self.var_transforms.get(name, ()):
            v = apply_spec(spec, v)
        return v

    def transformed_shape(self, name: str, shape) -> Tuple[int, ...]:
        s = tuple(int(d) for d in shape)
        for spec in self.var_transforms.get(name, ()):
            s = spec_shape(spec, s)
        return s

    def transformed_shapes(self, shapes: Dict) -> Dict:
        return rehomed_shapes(shapes, self.var_transforms,
                              self.input_layouts)

    def inverse_var(self, name: str, value):
        v = value if isinstance(value, torch.Tensor) else np.asarray(value)
        for spec in reversed(self.var_transforms.get(name, ())):
            v = apply_spec(spec, v, inverse=True)
        return v

    def materialize_params(self, arg_params: Dict) -> Dict:
        """The values of every pass-synthesized variable, from the ORIGINAL
        parameters (on their device): the extra parameters the caller
        binds. The int8 arithmetic is ``contrib.quantization.
        quantize_params``'s."""
        if not self.synth_params:
            return {}
        from .. import ndarray as nd_mod
        from ..context import current_context
        src = dict(arg_params)
        ctx = next((v.context for v in src.values()
                    if hasattr(v, "context")), None) or current_context()
        for name, spec in self.synth_sources.items():
            if spec[0] != "zeros":
                raise MXNetError(f"unknown synth-source spec {spec!r}")
            src[name] = nd_mod.zeros(tuple(int(d) for d in spec[1]),
                                     ctx=ctx)
        out: Dict[str, Any] = {}
        quant_cache: Dict[str, Dict] = {}
        for name, spec in self.synth_params.items():
            kind = spec[0]
            if kind == "const":
                out[name] = nd_mod.array(np.float32(spec[1]), ctx=ctx)
            elif kind == "quant_of":
                pname, part = spec[1], spec[2]
                if pname not in quant_cache:
                    from ..contrib.quantization import quantize_params
                    if pname not in src:
                        raise MXNetError(
                            f"synthesized param {name!r} derives from "
                            f"{pname!r}, which is not in arg_params")
                    quant_cache[pname] = quantize_params({pname: src[pname]})
                out[name] = quant_cache[pname][f"{pname}_{part}"]
            else:
                raise MXNetError(f"unknown synth-param spec {spec!r}")
        return out


def default_names(spec: Optional[str] = None) -> Tuple[str, ...]:
    """A pipeline spelling (the ``MXNET_PASSES`` grammar) -> pass names in
    order; ``None`` reads the environment."""
    if spec is None:
        spec = str(get_env("MXNET_PASSES", "") or "")
    spec = spec.strip()
    if spec.lower() in ("0", "off", "none", "false"):
        return ()
    if not spec:
        return DEFAULT_PIPELINE
    tokens = [t.strip() for t in spec.split(",") if t.strip()]
    removed = {t[1:].strip() for t in tokens if t.startswith("-")}
    listed = [t for t in tokens if not t.startswith("-")]
    base = list(listed) if listed else list(DEFAULT_PIPELINE)
    for name in set(base) | removed:
        if name not in PASS_REGISTRY:
            raise MXNetError(
                f"unknown graph pass {name!r} "
                f"(registered: {', '.join(sorted(PASS_REGISTRY))})")
    return tuple(n for n in base if n not in removed)


class PassManager:
    """An ordered pipeline of graph passes: names, :class:`Pass`
    instances or classes, or a spec string in the ``MXNET_PASSES``
    grammar; ``None`` is the configured default. ``input_layout="NHWC"``
    says the caller feeds channel-last batches, so the layout pass may
    re-home rank-4 input variables."""

    def __init__(self, passes=None, input_layout: Optional[str] = None,
                 rehome_params: bool = True):
        if passes is None or isinstance(passes, str):
            self.passes: List[Pass] = [PASS_REGISTRY[n]()
                                       for n in default_names(passes)]
        else:
            self.passes = []
            for p in passes:
                if isinstance(p, Pass):
                    self.passes.append(p)
                elif isinstance(p, str):
                    if p not in PASS_REGISTRY:
                        raise MXNetError(f"unknown graph pass {p!r}")
                    self.passes.append(PASS_REGISTRY[p]())
                elif isinstance(p, type) and issubclass(p, Pass):
                    self.passes.append(p())
                else:
                    raise MXNetError(f"not a pass: {p!r}")
        if input_layout not in (None, "NHWC"):
            raise MXNetError("input_layout must be None or 'NHWC', got %r"
                             % (input_layout,))
        self.input_layout = input_layout
        self.rehome_params = bool(rehome_params)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.passes)

    def __len__(self):
        return len(self.passes)

    def __repr__(self):
        return f"<PassManager {','.join(self.names) or '(empty)'}>"

    def init_view(self, arrays):
        """The sample batch as the NET expects it for the deferred-init
        forward: under ``input_layout='NHWC'`` rank-4 arrays are permuted
        back to NCHW for that forward only."""
        if self.input_layout != "NHWC":
            return list(arrays)
        return [a.permute(0, 3, 1, 2) if isinstance(a, torch.Tensor)
                and a.ndim == 4 else
                np.transpose(np.asarray(a), (0, 3, 1, 2))
                if getattr(a, "ndim", 0) == 4 else a for a in arrays]

    def run(self, sym, shapes=None, dtypes=None, input_vars: Sequence[str] = (),
            param_names: Optional[Sequence[str]] = None,
            rehome_params: Optional[bool] = None) -> PassResult:
        """Run the pipeline over ``sym``. ``shapes`` are the input shapes
        (parameter shapes come from the executor's rules). With no rewrite
        ``result.symbol is sym``."""
        ctx = PassContext(
            shapes=shapes, dtypes=dtypes, input_vars=input_vars,
            param_names=param_names,
            rehome_params=self.rehome_params if rehome_params is None
            else bool(rehome_params),
            input_layout=self.input_layout)
        cur = sym
        for p in self.passes:
            try:
                cur, n = p.apply(cur, ctx)
            except MXNetError:
                raise
            except Exception as e:
                # a pass never takes a capture down: the last good graph
                # goes on, with a warning
                logger.warning("graph pass %r failed, skipped: %r",
                               p.name, e)
                n = 0
            ctx.counts[p.name] = ctx.counts.get(p.name, 0) + int(n)
        return PassResult(cur, ctx, self.names)


def resolve(passes) -> Optional[PassManager]:
    """The ``passes=`` argument of Module and the trainer: ``None`` the
    environment's default pipeline (None when that is empty); ``True``
    the default pipeline whatever the environment says; any falsy
    spelling (``False``, ``0``, ``""``, ``()``) off; a
    :class:`PassManager` itself; a spec string or sequence a custom
    pipeline."""
    if passes is None:
        mgr = PassManager()
        return mgr if len(mgr) else None
    if passes is True:
        return PassManager(DEFAULT_PIPELINE)
    if isinstance(passes, PassManager):
        return passes if len(passes) else None
    if not passes or (isinstance(passes, str) and not passes.strip()):
        return None
    mgr = PassManager(passes)
    return mgr if len(mgr) else None
