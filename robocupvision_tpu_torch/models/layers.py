"""Parameter registry, the registry-named ``nn.Module``, and the block
functions of the zoo's families.

``Registry`` is a copy of the JAX package's: it declares parameters in
PyTorch state_dict order with PyTorch state_dict names (e.g.
``downPart.Level0.layers.Conv0.conv.weight``) and records each shape in the
JAX package's layout (HWIO kernels), so the two registries compare equal.
``ParamSpec.torch_shape`` gives the layout the port stores:

  conv   (kh, kw, in, out) -> (out, in, kh, kw)
  tconv  (kh, kw, in, out) -> (in, out, kh, kw)   (unflipped, torch's own)
  linear (in, out)         -> (out, in)

``RegistryModule`` holds those tensors as parameters (BN running stats as
buffers) under exactly the registry names, so ``state_dict()`` keys and
order are the registry's (and the reference's torch checkpoints').

Block functions take a flat ``{name: tensor}`` dict and NHWC activations and
reproduce the reference's op orders. They run in eval mode unless called
inside :func:`train_mode`, where every BN normalizes by its batch
statistics (leaving out the samples :func:`bn_stats_mask` marks padded)
and writes its new running statistics into the dict ``train_mode`` yields
(the JAX package threads that dict through as ``mut``), every
:func:`dropout2d` site drops channels and every :func:`dropout` site
elements by the keep mask and rate ``train_mode`` was given for it. The
op orders (its model.py:105-199, 256-267, 403-414):
  conv_block:        conv -> ReLU -> BN        (BN after ReLU!)
  conv_pool_simple:  conv -> BN -> ReLU
  conv_pool:         dilated conv1 -> ReLU -> stride-2 pool conv -> BN -> ReLU
  conv_pool_double:  dilated conv1 -> ReLU -> dilated conv2 -> ReLU
                     -> stride-2 pool conv -> BN -> ReLU
  up_tconv:          tconv -> BN -> ReLU
  classifier:        optional max pool -> conv
  ult_classifier:    optional global mean -> Dropout2d (train) -> conv
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn as tnn

from robocupvision_tpu_torch.ops import init as pinit
from robocupvision_tpu_torch.ops import nn

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    name: str
    shape: Tuple[int, ...]  # JAX-package layout (HWIO kernels)
    kind: str  # conv_w|conv_b|tconv_w|tconv_b|lin_w|lin_b|bn_w|bn_b|bn_rm|bn_rv

    @property
    def torch_shape(self) -> Tuple[int, ...]:
        if self.kind == "conv_w":
            kh, kw, cin, cout = self.shape
            return (cout, cin, kh, kw)
        if self.kind == "tconv_w":
            kh, kw, cin, cout = self.shape
            return (cin, cout, kh, kw)
        if self.kind == "lin_w":
            cin, cout = self.shape
            return (cout, cin)
        return self.shape


class Registry:
    """Ordered parameter declaration mirroring torch module registration."""

    def __init__(self) -> None:
        self.specs: "OrderedDict[str, ParamSpec]" = OrderedDict()

    def _add(self, name: str, shape: Tuple[int, ...], kind: str) -> None:
        assert name not in self.specs, f"duplicate param {name}"
        self.specs[name] = ParamSpec(name, shape, kind)

    def conv(self, name: str, cin: int, cout: int, k, bias: bool = True) -> None:
        kh, kw = (k, k) if isinstance(k, int) else k
        self._add(name + ".weight", (kh, kw, cin, cout), "conv_w")
        if bias:
            self._add(name + ".bias", (cout,), "conv_b")

    def tconv(self, name: str, cin: int, cout: int, k=3, bias: bool = True) -> None:
        kh, kw = (k, k) if isinstance(k, int) else k
        self._add(name + ".weight", (kh, kw, cin, cout), "tconv_w")
        if bias:
            self._add(name + ".bias", (cout,), "tconv_b")

    def bn(self, name: str, c: int) -> None:
        self._add(name + ".weight", (c,), "bn_w")
        self._add(name + ".bias", (c,), "bn_b")
        self._add(name + ".running_mean", (c,), "bn_rm")
        self._add(name + ".running_var", (c,), "bn_rv")

    def linear(self, name: str, cin: int, cout: int, bias: bool = True) -> None:
        self._add(name + ".weight", (cin, cout), "lin_w")
        if bias:
            self._add(name + ".bias", (cout,), "lin_b")

    def init(self, gen: torch.Generator) -> Params:
        """Torch-layout params with PyTorch layer defaults, drawn in registry
        order from ``gen`` (on the CPU)."""
        params: Params = OrderedDict()
        for name, spec in self.specs.items():
            k = spec.kind
            if k in ("conv_w", "tconv_w"):
                kh, kw, cin, cout = spec.shape
                fn = pinit.conv_weight if k == "conv_w" else pinit.tconv_weight
                params[name] = fn(gen, kh, kw, cin, cout)
            elif k in ("conv_b", "tconv_b"):
                wspec = self.specs[name[: -len(".bias")] + ".weight"]
                kh, kw, cin, cout = wspec.shape
                fn = pinit.conv_bias if k == "conv_b" else pinit.tconv_bias
                params[name] = fn(gen, kh, kw, cin, cout)
            elif k == "lin_w":
                params[name] = pinit.linear_weight(gen, *spec.shape)
            elif k == "lin_b":
                wspec = self.specs[name[: -len(".bias")] + ".weight"]
                params[name] = pinit.linear_bias(gen, *wspec.shape)
            elif k in ("bn_w", "bn_rv"):
                params[name] = pinit.bn_weight(spec.shape[0])
            elif k in ("bn_b", "bn_rm"):
                params[name] = pinit.bn_bias(spec.shape[0])
            else:  # pragma: no cover
                raise ValueError(k)
        return params

    @property
    def order(self) -> List[str]:
        return list(self.specs)


def is_weight(name: str) -> bool:
    """Trainable-vs-state split: BN running stats are state, the rest train."""
    return not (name.endswith(".running_mean") or name.endswith(".running_var"))


def split_params(params: Params) -> Tuple[Params, Params]:
    """(trainable, state): the BN running statistics are the state."""
    train = {k: v for k, v in params.items() if is_weight(k)}
    state = {k: v for k, v in params.items() if not is_weight(k)}
    return train, state


class RegistryModule(tnn.Module):
    """An ``nn.Module`` whose parameters (and BN-statistic buffers) sit at
    the registry's dotted names, built as nested submodules."""

    def __init__(self, registry: Registry, params: Params) -> None:
        super().__init__()
        for name, spec in registry.specs.items():
            t = params[name]
            if tuple(t.shape) != spec.torch_shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{spec.torch_shape}")
            *path, leaf = name.split(".")
            mod: tnn.Module = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, tnn.Module())
                mod = getattr(mod, part)
            if is_weight(name):
                mod.register_parameter(leaf, tnn.Parameter(t, requires_grad=False))
            else:
                mod.register_buffer(leaf, t)

    def flat(self) -> Params:
        """{registry name: tensor} view used by the block functions."""
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}


# ---- train mode ---------------------------------------------------------------

# The dict a train-mode forward writes the new BN running statistics into,
# and the (N,) mask of the batch's real samples; both ambient, so that no
# block signature carries them.
_BN_TRAIN_MUT: contextvars.ContextVar = contextvars.ContextVar(
    "bn_train_mut", default=None)
_BN_SAMPLE_MASK: contextvars.ContextVar = contextvars.ContextVar(
    "bn_sample_mask", default=None)
# {dropout site: (keep mask, p)} of the train-mode forward
_DROPS: contextvars.ContextVar = contextvars.ContextVar("drops", default=None)


@contextlib.contextmanager
def train_mode(drops: Optional[Mapping[str, Tuple[torch.Tensor, float]]]
               = None) -> Iterator[Params]:
    """Run the blocks in train mode; yields the dict of new running
    statistics (``mut``) that the forward fills. ``drops``: the keep mask
    and rate of each dropout site the forward drops at
    ({site: (bool keep mask, p)}: (N, 1, 1, C) at a :func:`dropout2d`
    site, the activation's shape at a :func:`dropout` site)."""
    mut: Params = {}
    token = _BN_TRAIN_MUT.set(mut)
    drop_token = _DROPS.set(drops or {})
    try:
        yield mut
    finally:
        _DROPS.reset(drop_token)
        _BN_TRAIN_MUT.reset(token)


@contextlib.contextmanager
def bn_stats_mask(mask: Optional[torch.Tensor]) -> Iterator[None]:
    """Leave the samples where ``mask`` (N,) is 0 out of the BN batch
    statistics of a train-mode forward."""
    token = _BN_SAMPLE_MASK.set(mask)
    try:
        yield
    finally:
        _BN_SAMPLE_MASK.reset(token)


# ---- block applications -------------------------------------------------------


def conv(p: Params, name: str, x, stride=1, padding=0, dilation=1):
    return nn.conv2d(x, p[name + ".weight"], p.get(name + ".bias"),
                     stride=stride, padding=padding, dilation=dilation)


def tconv(p: Params, name: str, x, stride=2, padding=1, output_padding=1):
    return nn.conv_transpose2d(x, p[name + ".weight"], p.get(name + ".bias"),
                               stride=stride, padding=padding,
                               output_padding=output_padding)


def bn(p: Params, name: str, x):
    mut = _BN_TRAIN_MUT.get()
    if mut is None:
        return nn.batch_norm(x, p[name + ".weight"], p[name + ".bias"],
                             p[name + ".running_mean"],
                             p[name + ".running_var"])
    y, rm, rv = nn.batch_norm_train(
        x, p[name + ".weight"], p[name + ".bias"], p[name + ".running_mean"],
        p[name + ".running_var"], sample_mask=_BN_SAMPLE_MASK.get())
    mut[name + ".running_mean"] = rm
    mut[name + ".running_var"] = rv
    return y


def _drop(x: torch.Tensor, site: str, fn) -> torch.Tensor:
    drops = _DROPS.get()
    if _BN_TRAIN_MUT.get() is None or site not in drops:
        return x
    keep, p = drops[site]
    return fn(x, keep, p)


def dropout2d(x: torch.Tensor, site: str) -> torch.Tensor:
    """Dropout2d at dropout site ``site`` by the keep mask and rate
    :func:`train_mode` was given for the site; the identity at a site it
    was given none for (eval mode, a rate of 0)."""
    return _drop(x, site, nn.dropout2d)


def dropout(x: torch.Tensor, site: str) -> torch.Tensor:
    """Element dropout (nn.Dropout) at dropout site ``site``, its keep mask
    of x's shape; the identity outside train mode, as :func:`dropout2d`."""
    return _drop(x, site, nn.dropout)


# Reference block: Conv = conv -> ReLU -> BN (model.py:105-116)
def conv_block_def(r: Registry, name: str, cin: int, cout: int, k: int) -> None:
    r.conv(name + ".conv", cin, cout, k, bias=True)
    r.bn(name + ".bn", cout)


def conv_block(p, name, x, stride, k):
    y = conv(p, name + ".conv", x, stride=stride, padding=k // 2)
    return bn(p, name + ".bn", nn.relu(y))


# Reference block: ConvPoolSimple = conv -> BN -> ReLU (model.py:166-176)
def conv_pool_simple_def(r: Registry, name: str, cin: int, cout: int, k: int,
                         bias: bool) -> None:
    r.conv(name + ".conv", cin, cout, k, bias=bias)
    r.bn(name + ".bn", cout)


def conv_pool_simple(p, name, x, stride, padding, dilation):
    y = conv(p, name + ".conv", x, stride=stride, padding=padding,
             dilation=dilation)
    return nn.relu(bn(p, name + ".bn", y))


# Reference block: ConvPool (model.py:126-142)
def conv_pool_def(r: Registry, name: str, cin: int, cout: int) -> None:
    r.conv(name + ".conv1", cin, cout, 3, bias=False)
    r.conv(name + ".pool", cout, cout, 3, bias=False)
    r.bn(name + ".bn", cout)


def conv_pool(p, name, x):
    y = nn.relu(conv(p, name + ".conv1", x, padding=2, dilation=2))
    y = conv(p, name + ".pool", y, stride=2, padding=1)
    return nn.relu(bn(p, name + ".bn", y))


# Reference block: ConvPoolDouble (model.py:144-164)
def conv_pool_double_def(r: Registry, name: str, cin: int, cout: int) -> None:
    r.conv(name + ".conv1", cin, cout, 3, bias=False)
    r.conv(name + ".conv2", cout, cout, 3, bias=False)
    r.conv(name + ".pool", cout, cout, 3, bias=False)
    r.bn(name + ".bn", cout)


def conv_pool_double(p, name, x):
    y = nn.relu(conv(p, name + ".conv1", x, padding=2, dilation=2))
    y = nn.relu(conv(p, name + ".conv2", y, padding=2, dilation=2))
    y = conv(p, name + ".pool", y, stride=2, padding=1)
    return nn.relu(bn(p, name + ".bn", y))


# Reference block: upSampleTransposeConv = tconv -> BN -> ReLU (model.py:178-194)
def up_tconv_def(r: Registry, name: str, cin: int, cout: int) -> None:
    r.tconv(name + ".conv", cin, cout, 3, bias=True)
    r.bn(name + ".bn", cout)


def up_tconv(p, name, x):
    y = tconv(p, name + ".conv", x, stride=2, padding=1, output_padding=1)
    return nn.relu(bn(p, name + ".bn", y))


# Reference block: LevelDown (model.py:379-401)
def level_down_def(r: Registry, name: str, cin: int, cout: int, levels: int,
                   do_pool: bool, pool: bool) -> None:
    if pool:
        if do_pool:
            levels -= 1
        r_levels = max(levels, 1)
        conv_block_def(r, name + ".layers.Conv0", cin, cout, 3)
        for i in range(r_levels - 1):
            conv_block_def(r, f"{name}.layers.Conv{i + 1}", cout, cout, 3)
    else:
        conv_block_def(r, name + ".layers.Conv0", cin, cout, 3)
        for i in range(levels - 1):
            conv_block_def(r, f"{name}.layers.Conv{i + 1}", cout, cout, 3)


def level_down(p, name, x, levels, do_pool, pool):
    if pool:
        if do_pool:
            x = nn.max_pool(x, 2, 2)
            levels -= 1
        levels = max(levels, 1)
        x = conv_block(p, name + ".layers.Conv0", x, 1, 3)
        for i in range(levels - 1):
            x = conv_block(p, f"{name}.layers.Conv{i + 1}", x, 1, 3)
    else:
        x = conv_block(p, name + ".layers.Conv0", x, 2 if do_pool else 1, 3)
        for i in range(levels - 1):
            x = conv_block(p, f"{name}.layers.Conv{i + 1}", x, 1, 3)
    return x


# Reference block: UltClassifier (model.py:403-414)
def ult_classifier_def(r: Registry, name: str, cin: int, n_class: int,
                       size: int = 1) -> None:
    r.conv(name + ".layers.Class", cin, n_class, size, bias=True)


def ult_classifier(p, name, x, size: int, pool: bool = False):
    """``pool``: the classification form, a global mean over H, W first
    (AdaptiveAvgPool2d(1)), then Dropout2d at site ``name`` in train
    mode."""
    if pool:
        x = dropout2d(nn.adaptive_avg_pool_1(x), name)
    return conv(p, name + ".layers.Class", x, padding=size // 2)


def join(name: str, child: str) -> str:
    """Module-path join tolerating an empty prefix (standalone heads keep the
    reference's bare torch names, e.g. 'classifier.weight')."""
    return child if not name else name + "." + child


# Reference block: Classifier (model.py:256-267)
def classifier_def(r: Registry, name: str, cin: int, n_class: int,
                   kernel: int = 1) -> None:
    r.conv(join(name, "classifier"), cin, n_class, kernel, bias=True)


def classifier(p, name, x, pool_size: int, kernel: int):
    if pool_size > 1:
        x = nn.max_pool(x, pool_size, pool_size)
    return conv(p, join(name, "classifier"), x, padding=kernel // 2)
