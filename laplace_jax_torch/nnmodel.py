"""Model adapter with layer taps (port of `laplace_jax/nnmodel.py`: the
Dense, Conv, DenseGeneral, Einsum, Embed and norm taps, a trainable subset
of leaves and the last-layer helpers).

`apply_with_taps` plants a forward hook on every layer the KFAC taps take
(`kfac_tap`): a Dense (`nn.Linear`), a conv (the flax `Conv` twin of
`models/flax_layers.py` with its groups, padding, input dilation and mask,
`models.resnet.Conv` among its cases, and every `nn.Conv1d`, `nn.Conv2d` and
`nn.Conv3d` with any `groups` and zero or circular padding; the spec keeps
each one's own pads), an `Embed` (the tap keeps the ids and
`num_embeddings`), and a `DenseGeneral` or `Einsum` twin, whose tap
(`general_linear_tap`, the JAX package's `_general_linear_tap`,
`laplace_jax/nnmodel.py:475-620`) is one of three: `dense_general`, with
the activation rows `(B, T, K)` in the kernel's contracted order and the
cotangent's permutation; `unfactored`, for a batch-separable equation with
no two-factor structure (exact per-leaf curvature, no output offset); or
none, for `batch_dims`, a batch-contracting or a call-time equation (the
leaves then follow the `unsupported` policy). With `norm=True`, the norm
twins of `models/flax_layers.py` are tapped too (`norm_tap`), their tap
keeping the output, `scale`, `bias` and feature axis, as the JAX package's
does (`laplace_jax/nnmodel.py:250-273`). The exact GGN's KFAC fit takes no
norm taps; the `block` policy and the tap diagonal do.
A Dense whose rows were gathered by a router (`models.deepseek_v2.RoutedLinear`,
a held expert's projection on the `(rows, in)` tokens routed to it) sets
`routed_positions` before each call; its tap's spec keeps it as
`positions`, the positions per sample of the batch the rows came from, by
which KFAC divides its activation Gram (a token not routed there is a zero
row of a and g).
The hook records the layer's input and adds a zero tensor that requires
grad to the layer's output: the gradient with respect to that zero
offset is the layer's output gradient, which KFAC needs for its B factor
(the JAX package differentiates the same zero offsets through a flax
interceptor, `laplace_jax/nnmodel.py:205-212`).

A last layer is a module path such as `("Dense_0",)`; its leaves are the
parameters whose module path is exactly that path. Discovery
(`find_last_layer`) probes one input through the same hooks, planted on
every layer of a kind the JAX package taps (`utils/flatten.layer_kind`, the
one classification of layers): the last executed Dense, else the last
executed conv, DenseGeneral, norm or embedding layer that has parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import math
import re
import string

import torch
from torch import nn

from laplace_jax_torch.enums import FeatureReduction
from laplace_jax_torch.models.flax_layers import Conv
from laplace_jax_torch.utils.flatten import (
    layer_kind,
    leaf_specs,
    parameters_to_vector,
    vector_to_parameters,
)


@dataclass
class LayerTap:
    """One executed layer."""

    path: tuple  # module path, e.g. ("ResidualBlock_0", "Conv_0")
    # "dense" | "conv" | "dense_general" | "unfactored" | "embed" | "norm", or
    # any `layer_kind` (a probe)
    kind: str
    inputs: torch.Tensor  # layer input (NCHW for convs, the ids for an embedding)
    offset: Optional[torch.Tensor]  # zero added to the output, requiring grad (None: unfactored)
    # conv: kernel_size, strides, padding, dilation, input_dilation, wrap,
    # groups, mask (torch layout, or None); embed: num_embeddings;
    # dense_general: n_feat, g_perm, g_perm_bias, kernel_layout; a routed
    # dense: positions (per sample, of the batch its rows were gathered from)
    spec: Optional[dict] = None
    outputs: Optional[torch.Tensor] = None  # norm: the output (detached)
    module: Optional[nn.Module] = None  # norm: the layer (`scale`, `bias`, `axis`)
    patches: Optional[torch.Tensor] = None  # dense_general: activation rows (B, T, K)


def batch_len(x) -> int:
    """The batch size of an input, or of a dict input's first tensor."""
    if isinstance(x, Mapping):
        x = next(v for v in x.values() if torch.is_tensor(v))
    return x.shape[0]


def batch_slice(x, sl: slice):
    """Rows `sl` of an input; a dict input keeps its non-tensor entries."""
    if isinstance(x, Mapping):
        return {k: v[sl] if torch.is_tensor(v) else v for k, v in x.items()}
    return x[sl]


def unpack_batch(data, dict_key_y: str):
    """(X, y) from a pair, or from a dict batch, which is itself X and holds
    y under `dict_key_y` (reference `baselaplace.py:969-974`)."""
    if isinstance(data, Mapping):
        return data, data[dict_key_y]
    X, y = data
    return X, y


def shape_error(exc: Exception) -> bool:
    """Whether an exception of a one-sample forward is a shape error, as a
    parameter shape-coupled to the batch (a `DenseGeneral` with
    `batch_dims`) raises it: a `ValueError` or `TypeError`, or torch's
    `RuntimeError` for sizes or shapes that do not match."""
    if isinstance(exc, (ValueError, TypeError)):
        return True
    if isinstance(exc, torch.OutOfMemoryError) or not isinstance(exc, RuntimeError):
        return False
    return re.search(r"size|shape|dimension|broadcast", str(exc)) is not None


def _module_path(name: str) -> tuple:
    return tuple(name.split(".")) if name else ()


def flax_module_name(name: str | None) -> str | None:
    """A torch module name (`"head.fc"`) as the JAX package writes a module
    path (`"head/fc"`), as a saved state's `_last_layer_name` holds it."""
    return None if name is None else name.replace(".", "/")


def conv_spec(mod: nn.Module) -> Optional[dict]:
    """The patch spec (`ops/im2col.py` arguments, the groups and the mask)
    of a conv the KFAC taps take, or None (an `nn.ConvNd` padding by
    reflection or replication, which no flax conv does). An `nn.ConvNd`'s
    padding becomes (lo, hi) pairs: an int or a tuple pads both sides
    alike; torch's `'same'` pads `d (k - 1)` in all, the odd one at the end,
    as flax's `'SAME'` does; `padding_mode='circular'` wraps those pads
    (`wrap`), where flax's 'CIRCULAR' wraps `((e - 1) // 2, e // 2)`."""
    torch_conv = isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d))
    if not (isinstance(mod, Conv) or torch_conv) or (
            torch_conv and mod.padding_mode not in ("zeros", "circular")):
        return None
    spec = dict(kernel_size=tuple(mod.kernel_size), wrap=False)
    if isinstance(mod, Conv):
        return dict(spec, strides=mod.strides, padding=mod.padding,
                    dilation=mod.kernel_dilation, input_dilation=mod.input_dilation,
                    groups=mod.feature_group_count, mask=mod.mask)
    n = len(mod.kernel_size)
    if mod.padding == "valid":
        pads = [(0, 0)] * n
    elif mod.padding == "same":
        totals = [d * (k - 1) for k, d in zip(mod.kernel_size, mod.dilation)]
        pads = [(t // 2, t - t // 2) for t in totals]
    else:
        pads = [(p, p) for p in mod.padding]
    return dict(spec, strides=tuple(mod.stride), padding=pads, dilation=tuple(mod.dilation),
                input_dilation=None, wrap=mod.padding_mode == "circular", groups=mod.groups,
                mask=None)


def kfac_tap(mod: nn.Module) -> Optional[tuple]:
    """`(kind, spec)` of a layer the KFAC taps take (a Dense, a conv with a
    `conv_spec`, the Embed, DenseGeneral or Einsum twin), else None. A
    `dense_general` layer's tap is settled in the forward, from its input
    (`general_linear_tap`)."""
    kind = layer_kind(mod)
    if kind == "conv":
        spec = conv_spec(mod)
        return None if spec is None else (kind, spec)
    if kind == "embed" and hasattr(mod, "embedding"):  # the twin; torch's nn.Embedding is not tapped
        return kind, {"num_embeddings": int(mod.embedding.shape[0])}
    return (kind, None) if kind in ("dense", "dense_general") else None


def general_linear_tap(mod: nn.Module, a: torch.Tensor) -> Optional[tuple]:
    """The tap of a DenseGeneral or Einsum twin on the input `a`: `(
    "dense_general", spec, rows)` with the activation rows `(B, T, K)`, K
    the contracted axes flattened in the kernel's order and T the positions
    sharing the weight, and `spec` the cotangent's metadata (`n_feat`
    trailing feature axes after `g_perm` / `g_perm_bias`, the permutations
    of the output's axes into kernel / bias flatten order, None for the
    identity; `kernel_layout` "ko", contracted-major, or "ok",
    feature-major); `("unfactored", None, None)` for a batch-separable
    equation with no two-factor structure; None for `batch_dims`, a kernel
    axis tied to the batch, a batch-contracting or a call-time equation
    (the JAX package's `_general_linear_tap`, `laplace_jax/nnmodel.py:475-620`)."""
    if hasattr(mod, "contracted_axes"):  # DenseGeneral
        if mod.batch_dims:
            return None
        axis = mod.contracted_axes(a.ndim)
        if 0 in axis or len(set(axis)) != len(axis):
            return None
        rest = tuple(i for i in range(a.ndim) if i not in axis)
        K = math.prod(a.shape[ax] for ax in axis)
        rows = a.detach().permute(rest + axis).reshape(a.shape[0], -1, K)
        return "dense_general", dict(n_feat=len(mod.features), g_perm=None, g_perm_bias=None,
                                     kernel_layout="ko"), rows
    es = mod.einsum_str
    if es is None or "->" not in es or es.count(",") != 1:
        return None
    lhs_s, out_s = es.split("->")
    lhs_s, rhs_s = lhs_s.split(",")
    if "." in rhs_s:
        return None
    if "..." in lhs_s:
        n_batch = a.ndim - len(lhs_s.replace("...", ""))
        if n_batch < 0 or "..." not in out_s:
            return None
        pool = [c for c in string.ascii_letters if c not in lhs_s + rhs_s + out_s]
        if len(pool) < n_batch:
            return None
        batch = "".join(pool[:n_batch])
        lhs_s, out_s = lhs_s.replace("...", batch), out_s.replace("...", batch)
    if "." in lhs_s + out_s:
        return None
    lhs, rhs, out = list(lhs_s), list(rhs_s), list(out_s)

    def unfactored():
        # batch-separable: the batch label stays out of the kernel and reaches the output
        if lhs and lhs[0] not in rhs and lhs[0] in out:
            return "unfactored", None, None
        return None

    if len(set(lhs)) != len(lhs) or len(set(rhs)) != len(rhs) or len(set(out)) != len(out):
        return unfactored()  # repeated (diagonal) labels
    contracted = [c for c in rhs if c in lhs and c not in out]
    feat = [c for c in rhs if c not in lhs]
    if not contracted or not feat:
        return unfactored()
    if rhs == contracted + feat:
        layout = "ko"
    elif rhs == feat + contracted:
        layout = "ok"
    else:
        return unfactored()  # interleaved labels, or a kernel batch axis
    if any(c not in out for c in feat):
        return unfactored()  # a kernel feature axis summed out
    keep = [c for c in lhs if c not in contracted]
    if set(c for c in out if c not in feat) != set(keep) or not keep or lhs[0] != keep[0]:
        return unfactored()
    K = math.prod(a.shape[lhs.index(c)] for c in contracted)
    rows = a.detach().permute(tuple(lhs.index(c) for c in keep + contracted))
    rows = rows.reshape(a.shape[0], -1, K)
    identity = tuple(range(len(out)))
    g_perm = tuple(out.index(c) for c in keep + feat)
    g_perm_bias = tuple(out.index(c) for c in keep + [c for c in out if c in feat])
    return "dense_general", dict(n_feat=len(feat),
                                 g_perm=None if g_perm == identity else g_perm,
                                 g_perm_bias=None if g_perm_bias == identity else g_perm_bias,
                                 kernel_layout=layout), rows


def norm_tap(mod: nn.Module) -> bool:
    """Whether a layer is a norm the taps take: a twin of a flax norm
    (`models.flax_layers`, `tap_kind = "norm"`), out = scale ∘ x̂ + bias
    along its `axis`. torch's own norms are not tapped."""
    return getattr(type(mod), "tap_kind", None) == "norm"


class NNModel:
    """An `nn.Module` with its canonical parameter flattening and taps.

    `trainable` (a set of torch parameter names, the JAX package's
    `trainable_mask`) restricts the flat vector to those leaves; the others
    stay in the forward as constants. None means every parameter that
    requires grad.
    """

    def __init__(self, module: nn.Module, trainable=None):
        self.module = module
        self.trainable = trainable
        self.leaf_specs = leaf_specs(module, trainable)
        self.n_params = sum(s.size for s in self.leaf_specs)
        self.n_layers = len(self.leaf_specs)
        self._params = dict(module.named_parameters())

    @property
    def mean_vector(self) -> torch.Tensor:
        return parameters_to_vector(self.module, self.leaf_specs)

    def params_in_order(self) -> list:
        """Torch parameters in canonical leaf order."""
        return [self._params[s.name] for s in self.leaf_specs]

    def apply(self, x):
        return self.module(x)

    def output_probe(self, x) -> torch.Tensor:
        """The outputs of a forward of `x[:1]`, as the fits read the output
        size from; of the whole `x` when one input alone fails with a shape
        error (a model shape-coupled to the batch, whose Jacobians take the
        whole-batch fallback)."""
        with torch.no_grad():
            try:
                return self.apply(batch_slice(x, slice(0, 1)))
            except (RuntimeError, TypeError, ValueError) as exc:
                if not shape_error(exc):
                    raise
                return self.apply(x)

    def apply_vec(self, theta: torch.Tensor, x):
        """The forward with the trainable leaves taken from the flat vector
        `theta` (canonical order, flax layout); the other leaves as they are."""
        return torch.func.functional_call(self.module,
                                          vector_to_parameters(theta, self.leaf_specs), (x,))

    def apply_with_taps(self, x, paths=None, every_kind: bool = False, norm: bool = False):
        """Forward pass returning `(f, taps)`, taps in execution order; each
        tapped output but an `unfactored` one gets `+ zeros` requiring grad.
        With `paths` (a set of module paths), only those layers are tapped.
        The KFAC layers (`kfac_tap`) are tapped; with `norm`, so are the
        norm twins (`norm_tap`, their output kept); with `every_kind`, so is
        every other layer that has a `layer_kind` (with no conv spec), as
        discovery needs."""
        taps: list[LayerTap] = []

        def make_hook(path, kind, spec):
            def hook(mod, args, out):
                tap_kind, tap_spec, rows = kind, spec, None
                routed = getattr(mod, "routed_positions", None) if kind == "dense" else None
                if routed is not None:  # rows gathered from a batch of `routed` positions a sample
                    tap_spec = {"positions": routed}
                if kind == "dense_general":
                    tap = general_linear_tap(mod, args[0])
                    if tap is None:
                        return None
                    tap_kind, tap_spec, rows = tap
                if tap_kind == "unfactored":  # exact per-leaf curvature: no output gradient
                    taps.append(LayerTap(path, tap_kind, args[0], None))
                    return None
                off = torch.zeros_like(out).requires_grad_(True)
                keep = kind == "norm" and norm
                taps.append(LayerTap(path, tap_kind, args[0], off, tap_spec,
                                     out.detach() if keep else None, mod if keep else None,
                                     rows))
                return out + off

            return hook

        handles = []
        for name, mod in self.module.named_modules():
            path = _module_path(name)
            if paths is not None and path not in paths:
                continue
            tap = kfac_tap(mod)
            if tap is None and norm and norm_tap(mod):
                tap = ("norm", None)
            if tap is None and every_kind and layer_kind(mod) is not None:
                tap = (layer_kind(mod), None)
            if tap is not None:
                handles.append(mod.register_forward_hook(make_hook(path, *tap)))
        try:
            f = self.module(x)
        finally:
            for h in handles:
                h.remove()
        return f, taps

    # -- last layer ----------------------------------------------------------
    def _probe_taps(self, x, paths=None) -> list[LayerTap]:
        """The taps of every kind in a forward of `x[:1]` (reference
        `baselaplace.py:947-951` probes the same way)."""
        with torch.no_grad():
            _, taps = self.apply_with_taps(batch_slice(x, slice(0, 1)), paths, every_kind=True)
        return taps

    def find_last_layer(self, x) -> tuple:
        """Path of the head for last-layer Laplace: the last executed Dense
        (the closed-form φ⊗I Jacobians); with none, the last executed layer
        of another kind (conv, DenseGeneral, norm, embedding) that has
        parameters, whose Jacobians are taken over its leaves (the JAX
        package's `nnmodel.py:390-412`)."""
        taps = self._probe_taps(x)
        dense = [t.path for t in taps if t.kind == "dense"]
        if dense:
            return dense[-1]
        owned = {s.path[:-1] for s in leaf_specs(self.module)}
        for t in reversed(taps):
            if t.path in owned:
                return t.path
        raise ValueError("No Dense layer found for last-layer Laplace, and no other "
                         "parameterized tapped layer (Conv/DenseGeneral/norm) to fall back to.")

    def tap_kind(self, path: tuple, x) -> Optional[str]:
        """The kind of the layer at `path` in a forward of `x[:1]`, or None if
        it is not a tapped layer or does not run."""
        taps = self._probe_taps(x, {tuple(path)})
        return taps[0].kind if taps else None

    def head_kind(self, path: tuple, data) -> str:
        """The kind of the head at `path` from the probe `data`; "dense"
        (the common head) while there is no probe, or for a layer of no
        tapped kind, as the JAX package's `lllaplace.py:100-106` assumes."""
        return (None if data is None else self.tap_kind(path, data)) or "dense"

    def last_layer_param_paths(self, last_layer_path: tuple) -> list[tuple]:
        """Flax leaf paths of the parameters under the last layer."""
        sel = [s.path for s in leaf_specs(self.module) if s.path[:-1] == tuple(last_layer_path)]
        if not sel:
            raise ValueError(f"No parameters found under module path {last_layer_path}.")
        return sel

    def split_last_layer(self, last_layer_path: tuple) -> set:
        """The last layer's torch parameter names: the `trainable` set of a
        last-layer model. The layer may be of any kind; only a Dense head
        gets the closed-form Jacobians."""
        self.last_layer_param_paths(last_layer_path)
        return {s.name for s in leaf_specs(self.module) if s.path[:-1] == tuple(last_layer_path)}

    def apply_with_features(self, x, last_layer_path: tuple,
                            feature_reduction: FeatureReduction | str | None = None):
        """Forward returning `(f, features)`, the features being the last
        layer's input, reduced to (batch, dim) if asked
        (`feature_extractor.py:100-127`)."""
        feats = []
        mod = self.module.get_submodule(".".join(last_layer_path))
        handle = mod.register_forward_hook(lambda m, args, out: feats.append(args[0]))
        try:
            f = self.module(x)
        finally:
            handle.remove()
        if not feats:
            raise ValueError(f"Last layer {last_layer_path} not executed in forward.")
        phi = feats[-1]
        if phi.ndim > 2 and feature_reduction is not None:
            lead = tuple(range(1, phi.ndim - 1))
            if feature_reduction == FeatureReduction.PICK_FIRST:
                phi = phi[(slice(None),) + (0,) * len(lead)]
            elif feature_reduction == FeatureReduction.PICK_LAST:
                phi = phi[(slice(None),) + (-1,) * len(lead)]
            elif feature_reduction == FeatureReduction.AVERAGE:
                phi = phi.mean(dim=lead)
            else:
                raise ValueError(f"Invalid feature_reduction {feature_reduction}.")
        return f, phi
