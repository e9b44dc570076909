"""A whole dataset on the device, and its static-shape batches (the JAX
package's data/device_cache.py).

The RoboCup sets are small (thousands of QVGA frames): they are decoded
once on the host and kept on the card, and each epoch is cut into batches
there. The last batch is padded to the batch size, and a (B,) mask marks
the padded samples, which every loss and metric of the port ignores, so a
partial batch counts as the reference's variable-size one would.

On a mesh (parallel/mesh.py) every rank keeps the whole set and cuts its
own samples out of each global batch (``shard_rows``). The JAX package
shards the cache's memory over the data axis instead; the batches, and so
the results, are the same. A replicated cache costs every card the whole
set (a RoboCup set of a few thousand QVGA frames is a few hundred MB in
f32); a set larger than one card's memory is streamed instead
(data/streaming.py, whose ``sharding`` reads only the rank's samples).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DeviceCache:
    images: torch.Tensor   # (N, H, W, C) float32, normalized
    labels: torch.Tensor   # (N, H, W) or (N,) int
    n: int

    @classmethod
    def from_numpy(cls, images: np.ndarray, labels: np.ndarray,
                   device: DeviceLike = None) -> "DeviceCache":
        """Put the arrays on ``device`` (``cuda`` unless the caller passes
        another)."""
        dev = resolve_device(device)
        return cls(torch.from_numpy(np.ascontiguousarray(images)).to(dev),
                   torch.from_numpy(np.ascontiguousarray(labels)).to(dev),
                   int(images.shape[0]))


def shuffle(gen: torch.Generator, n: int) -> torch.Tensor:
    """An epoch's sample order: a permutation of range(n) drawn from
    ``gen``, on the generator's device (training's shuffle; the JAX
    package draws it from jax.random)."""
    return torch.randperm(n, generator=gen, device=gen.device)


def num_batches(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def epoch_batches(cache: DeviceCache, batch_size: int,
                  perm: Optional[Union[Sequence[int], torch.Tensor]] = None
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Yield (imgs, labels, sample_mask) batches of ``batch_size`` for one
    epoch, on the cache's device. ``perm``: the sample order, a permutation
    of range(n) (training's shuffle, e.g. :func:`shuffle`), or None for the
    sequential order of evaluation. The last batch is filled up with copies
    of sample 0, which its mask marks 0."""
    n = cache.n
    if n == 0:
        return
    dev = cache.images.device
    order = torch.arange(n, device=dev) if perm is None \
        else torch.as_tensor(perm, device=dev).long()
    nb = num_batches(n, batch_size)
    pad = nb * batch_size - n
    if pad > 0:
        order = torch.cat([order, torch.zeros(pad, dtype=order.dtype,
                                              device=dev)])
    mask = torch.cat([torch.ones(n, device=dev),
                      torch.zeros(pad, device=dev)])
    for b in range(nb):
        idx = order[b * batch_size:(b + 1) * batch_size]
        yield (cache.images[idx], cache.labels[idx],
               mask[b * batch_size:(b + 1) * batch_size])


def shard_rows(mesh, x: torch.Tensor, fill=None) -> torch.Tensor:
    """This rank's block of the leading dim of a global batch ``x`` (the
    batch itself, its sample mask, its draws or keep masks) on ``mesh``'s
    data axis. A batch the axis does not divide is first padded to a
    multiple of it with copies of row 0, or with ``fill`` (0 for the
    sample mask, which so marks the pad rows), which is exact: a row
    the mask marks 0 adds nothing to a loss, a statistic or a metric."""
    parts = mesh.shape["data"]
    pad = -x.shape[0] % parts
    if pad:
        rows = x[:1].expand((pad,) + tuple(x.shape[1:])) if fill is None \
            else torch.full((pad,) + tuple(x.shape[1:]), fill,
                            dtype=x.dtype, device=x.device)
        x = torch.cat([x, rows])
    size = x.shape[0] // parts
    return x[mesh.data_index * size:(mesh.data_index + 1) * size]
