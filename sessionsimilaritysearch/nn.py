"""A small neural-network module layer in plain JAX.

The models are written against the subset of the Flax linen API they use,
and this module provides exactly that subset, so the package needs nothing
beyond JAX and optax:

- ``Module``: a dataclass whose attributes configure it; submodules are
  created inline in ``__call__`` (``compact``) or assigned in ``setup()``,
  and named automatically (``Dense_0``, ``Dense_1``, ...), by ``name=``, or
  by the attribute they are assigned to. ``param``, ``variable``,
  ``make_rng``, ``is_initializing`` and ``variables`` work inside methods.
- ``init(rngs, *args) -> {"params": ...}`` and ``apply(variables, *args,
  rngs=..., method=..., mutable=...)``.
- layers: ``Dense``, ``Embed``, ``LayerNorm``, ``BatchNorm``, ``Dropout``;
  ``initializers`` and the activations the models call.

Parameter trees have the same paths, shapes and initial values as Flax's
(random streams are derived the same way: the key of a parameter is the
root key folded with a hash of its module path and a per-module counter),
so trees move between the two without conversion.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import inspect
import threading
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import gelu, leaky_relu, one_hot, relu, sigmoid, softmax, softplus  # noqa: F401
from jax.nn import initializers

_ctx = threading.local()


def _stack() -> list:
    """(module, phase) pairs of the module methods running on this thread;
    phase is 'setup' or 'call'."""
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


def _fold_in_static(key, suffix: tuple):
    """Fold a path of names and counters into ``key`` through one SHA-1 of
    the path, so every (module path, draw) gets an independent key."""
    if not suffix:
        return key
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


class _Root:
    """State shared by every scope of one ``init``/``apply`` call."""

    def __init__(self, variables: dict, mutable, initializing: bool):
        self.variables = variables
        self.mutable = mutable  # True (all) or a set of collection names
        self.initializing = initializing

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


class _Scope:
    """One module path: reads and writes its variables, derives its keys.

    ``counters`` holds the draw count per rng stream and, under
    ``("child", name)``, each child's counters, so a submodule re-created on
    a later call (or called twice) continues its streams instead of
    repeating them."""

    def __init__(self, root: _Root, path: tuple, rngs: dict, counters: dict):
        self.root = root
        self.path = path
        self.rngs = rngs  # stream name -> (root key, static suffix)
        self.counters = counters

    def push(self, name: str) -> "_Scope":
        rngs = {k: (key, suf + (name,)) for k, (key, suf) in self.rngs.items()}
        counters = self.counters.setdefault(
            ("child", name), {k: 0 for k in rngs}
        )
        return _Scope(self.root, self.path + (name,), rngs, counters)

    def make_rng(self, name: str):
        if name not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(
                    f"module {'/'.join(self.path) or '<root>'} needs an rng "
                    f"stream {name!r}: pass rngs={{{name!r}: key}}"
                )
            name = "params"
        self.counters[name] += 1
        key, suffix = self.rngs[name]
        return _fold_in_static(key, suffix + (self.counters[name],))

    def node(self, col: str, create: bool = False) -> Optional[dict]:
        d = self.root.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.root.variables[col] = {}
        for p in self.path:
            if p not in d:
                if not create:
                    return None
                d[p] = {}
            d = d[p]
        return d

    def get(self, col: str, name: str):
        d = self.node(col)
        return None if d is None else d.get(name)

    def put(self, col: str, name: str, value) -> None:
        if not self.root.is_mutable(col):
            raise ValueError(
                f"collection {col!r} is immutable here: pass "
                f"mutable=[{col!r}] to apply()"
            )
        self.node(col, create=True)[name] = value


class _Variable:
    """Handle on one variable (``Module.variable``) with a ``value``."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v) -> None:
        self._scope.put(self._col, self._name, v)


def compact(fn: Callable) -> Callable:
    """Marks a method that creates its submodules inline. Submodules are
    bound wherever they are created, so this is documentation only."""
    return fn


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            return fn(self, *args, **kwargs)
        stack = _stack()
        if not any(m is self for m, _ in stack):
            # a fresh (non-reentrant) call names its inline submodules
            # from _0 again, so a second call reuses the first's params
            object.__setattr__(self, "_autoname", {})
        stack.append((self, "call"))
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


def _bind(module: "Module", scope: _Scope) -> "Module":
    """Attach ``module`` to ``scope``, adopt its module-valued attributes
    (named after the attribute) and run its ``setup``."""
    object.__setattr__(module, "_scope", scope)
    object.__setattr__(module, "_autoname", {})
    for f in dataclasses.fields(module):
        if f.name == "name":
            continue
        v = getattr(module, f.name)
        nv = _adopt(module, v, f.name)
        if nv is not v:
            object.__setattr__(module, f.name, nv)
    if type(module).setup is not Module.setup:
        stack = _stack()
        stack.append((module, "setup"))
        try:
            module.setup()
        finally:
            stack.pop()
    return module


def _adopt(parent: "Module", value, name: str):
    """Bind a copy of a submodule (or of each in a list/tuple/dict) as a
    child of ``parent``; other values pass through."""
    if isinstance(value, Module):
        child = copy.copy(value)
        child_name = value.name or name
        object.__setattr__(child, "name", child_name)
        return _bind(child, parent._scope.push(child_name))
    if isinstance(value, (list, tuple)) and any(
        isinstance(v, Module) for v in value
    ):
        return type(value)(
            _adopt(parent, v, f"{name}_{i}") for i, v in enumerate(value)
        )
    if isinstance(value, dict) and any(
        isinstance(v, Module) for v in value.values()
    ):
        return {k: _adopt(parent, v, f"{name}_{k}") for k, v in value.items()}
    return value


_NOT_WRAPPED = {"setup", "__post_init__", "__init__", "__repr__",
                "__setattr__", "__init_subclass__"}


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class of every model component (see the module docstring)."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("__annotations__", {})
        for attr, fn in list(cls.__dict__.items()):
            if (inspect.isfunction(fn) and attr not in fields
                    and attr not in _NOT_WRAPPED
                    and (attr == "__call__" or not attr.startswith("_"))):
                setattr(cls, attr, _wrap_method(fn))
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_scope", None)
        stack = _stack()
        if not stack:
            return
        parent, phase = stack[-1]
        if phase != "call" or parent._scope is None:
            return  # created in setup(): bound when assigned to an attribute
        name = self.name
        if name is None:
            prefix = type(self).__name__
            i = parent._autoname.get(prefix, 0)
            parent._autoname[prefix] = i + 1
            name = f"{prefix}_{i}"
            object.__setattr__(self, "name", name)
        _bind(self, parent._scope.push(name))

    def __setattr__(self, attr: str, value) -> None:
        stack = _stack()
        if stack and stack[-1][0] is self and stack[-1][1] == "setup":
            value = _adopt(self, value, attr)
        object.__setattr__(self, attr, value)

    def setup(self) -> None:
        """Override to assign submodules as attributes."""

    # -- inside methods --------------------------------------------------
    def param(self, name: str, init_fn: Callable, *init_args):
        value = self._scope.get("params", name)
        if value is None:
            if not self._scope.root.initializing:
                raise ValueError(
                    f"parameter {'/'.join(self._scope.path + (name,))} is "
                    "missing from the variables passed to apply()"
                )
            value = init_fn(self._scope.make_rng("params"), *init_args)
            self._scope.put("params", name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        if self._scope.get(col, name) is None:
            self._scope.put(col, name, init_fn(*init_args))
        return _Variable(self._scope, col, name)

    def make_rng(self, name: str = "params"):
        return self._scope.make_rng(name)

    def is_initializing(self) -> bool:
        return self._scope.root.initializing

    @property
    def variables(self) -> dict:
        out = {}
        for col in self._scope.root.variables:
            d = self._scope.node(col)
            if d is not None:
                out[col] = d
        return out

    # -- entry points ------------------------------------------------------
    def _run(self, root: _Root, rngs, method, args, kwargs):
        if rngs is None:
            rngs = {}
        elif not isinstance(rngs, dict):
            rngs = {"params": rngs}
        scope = _Scope(root, (), {k: (v, ()) for k, v in rngs.items()},
                       {k: 0 for k in rngs})
        top = copy.copy(self)
        _bind(top, scope)
        if method is None:
            fn = type(top).__call__
        elif isinstance(method, str):
            fn = getattr(type(top), method)
        else:
            fn = getattr(method, "__func__", method)
        return fn(top, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        """Create every variable the traced method touches; ``rngs`` is a
        key (the 'params' stream) or a dict of streams."""
        root = _Root({}, True, initializing=True)
        self._run(root, rngs, method, args, kwargs)
        return root.variables

    def apply(self, variables: dict, *args, rngs=None, method=None,
              mutable=False, **kwargs):
        """Run ``method`` (default ``__call__``) with ``variables``.
        With ``mutable`` (a collection name or list of them) returns
        ``(out, updated_collections)``."""
        if isinstance(mutable, str):
            mutable = {mutable}
        elif mutable is not True:
            mutable = set(mutable or ())
        variables = {
            col: (jax.tree.map(lambda x: x, tree)
                  if mutable is True or col in mutable else tree)
            for col, tree in variables.items()
        }
        root = _Root(variables, mutable, initializing=False)
        out = self._run(root, rngs, method, args, kwargs)
        if not mutable:
            return out
        return out, {col: tree for col, tree in root.variables.items()
                     if mutable is True or col in mutable}


def _promote(*xs, inexact: bool = True):
    dtype = jnp.result_type(*[x for x in xs if x is not None])
    if inexact and not jnp.issubdtype(dtype, jnp.inexact):
        dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def _stats(x, axes: tuple):
    """Mean and (fast, clipped) variance over ``axes`` in at least f32."""
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mu = x.mean(axes)
    mu2 = lax.square(x).mean(axes)
    return mu, jnp.maximum(0.0, mu2 - lax.square(mu))


def _normalize(module: Module, x, mean, var, axes: tuple, epsilon: float):
    mean = jnp.expand_dims(mean, axes)
    var = jnp.expand_dims(var, axes)
    feat = (x.shape[-1],)
    y = x - mean
    mul = lax.rsqrt(var + epsilon)
    scale = module.param("scale", initializers.ones, feat, jnp.float32)
    mul = mul * scale
    y = y * mul
    bias = module.param("bias", initializers.zeros, feat, jnp.float32)
    y = y + bias
    return jnp.asarray(y, jnp.result_type(x, scale, bias))


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis."""

    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class Embed(Module):
    """Integer ids -> rows of a learned ``[num_embeddings, features]``
    table (``embedding``)."""

    num_embeddings: int
    features: int
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0
    )

    @property
    def embedding(self):
        return self.param("embedding", self.embedding_init,
                          (self.num_embeddings, self.features), jnp.float32)

    def __call__(self, inputs):
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Embed inputs must be integer ids")
        (table,) = _promote(self.embedding, inexact=False)
        return jnp.take(table, inputs, axis=0)


class LayerNorm(Module):
    """Normalize over the last axis, then learned scale and bias."""

    epsilon: float = 1e-6

    def __call__(self, x):
        mean, var = _stats(x, (x.ndim - 1,))
        return _normalize(self, x, mean, var, (x.ndim - 1,), self.epsilon)


class BatchNorm(Module):
    """Batch normalization over every axis but the last, keeping running
    statistics in the 'batch_stats' collection (updated when
    ``use_running_average`` is False and the collection is mutable)."""

    use_running_average: Optional[bool] = None
    momentum: float = 0.99
    epsilon: float = 1e-5

    def __call__(self, x, use_running_average: Optional[bool] = None):
        if use_running_average is None:
            use_running_average = self.use_running_average
        axes = tuple(range(x.ndim - 1))
        feat = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda s: jnp.zeros(s, jnp.float32), feat)
        ra_var = self.variable("batch_stats", "var",
                               lambda s: jnp.ones(s, jnp.float32), feat)
        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean, var = _stats(x, axes)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        return _normalize(self, x, mean, var, axes, self.epsilon)


class Dropout(Module):
    """Zero each element with probability ``rate`` (scaling the rest by
    ``1 / (1 - rate)``) unless ``deterministic``; draws from the 'dropout'
    rng stream."""

    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, inputs, deterministic: Optional[bool] = None):
        if deterministic is None:
            deterministic = self.deterministic
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), p=keep,
                                    shape=inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))

