"""The benchmark's own operation and byte counts, from the configurations'
layer shapes (frozen here, independent of the program's packed graphs).
This module holds what the families share; each family's file
(``families/<family>.py``) lists its own layers and chains.

- ``model_flops(config, h, w)``: the forward's FLOPs for one (h, w) image
  (the family's ``flops``). For the conv families: two per multiply-add
  of every convolution and transposed convolution, counting only the taps
  that land inside the input (padding taps do no work). Element-wise work
  (BatchNorm, ReLU, skip adds) is left out, so a share of a peak built on
  it cannot read high.
- ``k2_chains(config, n, h, w)``: each K2 chain that one forward of an
  (n, h, w) batch launches (the family's ``k2_chains``), with the original
  convs it computes (their useful taps, as above: the packed kernels'
  structural zeros are not work) and the bytes it must move: its input,
  skips and weights read once, each emitted output written once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from h100bench import core

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    dil: int
    h_in: int
    w_in: int
    transposed: bool = False

    @property
    def out_hw(self):
        if self.transposed:   # k3, s2, p1, output_padding 1
            return 2 * self.h_in, 2 * self.w_in
        eff = self.dil * (self.k - 1)
        return ((self.h_in + 2 * self.pad - eff - 1) // self.stride + 1,
                (self.w_in + 2 * self.pad - eff - 1) // self.stride + 1)

    def _valid(self, n_in: int, n_out: int, d: int) -> int:
        """Positions at which tap ``d`` of one axis reads the input."""
        if self.transposed:   # input i feeds output i*2 - 1 + d
            return sum(1 for i in range(n_in) if 0 <= 2 * i - 1 + d < n_out)
        off = d * self.dil - self.pad
        return sum(1 for o in range(n_out)
                   if 0 <= o * self.stride + off < n_in)

    @property
    def macs(self) -> int:
        ho, wo = self.out_hw
        taps = sum(self._valid(self.h_in, ho, dy) for dy in range(self.k)) \
            * sum(self._valid(self.w_in, wo, dx) for dx in range(self.k))
        return taps * self.cin * self.cout

    @property
    def flops(self) -> int:
        return 2 * self.macs


def _c(name, cin, cout, h, w, k=3, stride=1, pad=None, dil=1):
    pad = dil * (k // 2) if pad is None else pad
    return Conv(name, cin, cout, k, stride, pad, dil, h, w)


def model_flops(config: dict, h: int, w: int) -> int:
    """Forward FLOPs of one (h, w) image of ``config``."""
    return core.load_module("families", config["family"]).flops(
        config["cfg"], h, w)


@dataclasses.dataclass(frozen=True)
class Chain:
    tag: str
    convs: tuple
    read_bytes: int      # input, skips, weights and per-channel vectors
    write_bytes: int     # emitted outputs

    @property
    def flops(self) -> int:
        return sum(c.flops for c in self.convs)

    def seconds(self, flops_per_s: float, bytes_per_s: float) -> float:
        """The least time the card could take: the larger of the
        operations over the peak and the bytes over the memory rate."""
        return max(self.flops / flops_per_s,
                   (self.read_bytes + self.write_bytes) / bytes_per_s)


def _act(n, c: Conv, elt, out=True):
    """Bytes of a conv's (n-image) output, or of its input."""
    hh, ww = c.out_hw if out else (c.h_in, c.w_in)
    return n * hh * ww * (c.cout if out else c.cin) * elt


def _params(convs, elt, vectors):
    return sum(c.k * c.k * c.cin * c.cout * elt + vectors * c.cout * 4
               for c in convs)


def k2_chains(config: dict, n: int, h: int,
              w: int) -> Optional[List[Chain]]:
    """The K2 chains of one forward of an (n, h, w) batch through the
    configuration's served graph (its family file's ``k2_chains``), or
    None for a family whose served graph runs no K2 chain."""
    fam = core.load_module("families", config["family"])
    if not hasattr(fam, "k2_chains"):
        return None
    return fam.k2_chains(config, n, h, w)
