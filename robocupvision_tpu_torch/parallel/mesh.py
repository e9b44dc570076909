"""The (data x spatial) device mesh over torch.distributed (the JAX
package's parallel/mesh.py).

One process per device, all in one process group: NCCL between cards,
gloo between CPU processes (and between ranks that share one card, which
NCCL refuses). Rank ``d * spatial + s`` sits at mesh coordinates
(data ``d``, spatial ``s``), as the JAX mesh reshapes its devices.

- ``data`` splits the batch. Parameters and optimizer state are
  replicated; the train step sums its gradients over the mesh once a step
  (``all_reduce_flat``), and BatchNorm's statistics and the loss's
  normalisation are sums over the whole mesh (``all_reduce_sum``), so the
  step equals the one-device step on the global batch.
- ``spatial`` splits the image height. The conv, transposed conv and max
  pool of the model's blocks (``models/layers.py`` under
  ``layers.mesh_context``) fetch the rows their windows need from the
  neighbouring ranks (``halo_exchange``) and compute only this rank's
  output rows (``SpatialRows``). Rank ``s`` owns rows
  ``[H * s // S, H * (s + 1) // S)`` of every activation of global
  height ``H``, at every level (docs/SCALING_TORCH.md).

In JAX, XLA's SPMD partitioner inserts these collectives; here each is an
autograd function of its own around ``dist.all_reduce`` /
``dist.all_gather``, so that the backward runs the transposed collective.
With gloo, collectives of CUDA tensors go through host copies made here;
the computation stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.ops import nn


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _default_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (torchrun's variable), else the rank's card
    among the visible ones."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        local = (dist.get_rank() if dist.is_initialized() else 0) % max(n, 1)
    return resolve_device(f"cuda:{int(local)}")


class Mesh:
    """A (data x spatial) mesh over the default process group: this rank's
    coordinates, its device, and the groups of its ``data`` axis (the
    ranks that share its spatial coordinate) and its ``spatial`` axis (the
    ranks that share its data coordinate)."""

    def __init__(self, data: int, spatial: int, device: torch.device):
        self.shape = {"data": data, "spatial": spatial}
        self.size = data * spatial
        self.rank = dist.get_rank()
        self.data_index, self.spatial_index = divmod(self.rank, spatial)
        self.device = device
        self.group = dist.group.WORLD
        self.backend = dist.get_backend()
        # gloo's collectives take host tensors: a card's tensors are staged
        self.stage = self.backend == "gloo" and device.type == "cuda"
        # every rank creates every subgroup, in one order
        for s in range(spatial):
            g = dist.new_group([d * spatial + s for d in range(data)])
            if s == self.spatial_index:
                self.data_group = g
        for d in range(data):
            g = dist.new_group([d * spatial + s for s in range(spatial)])
            if d == self.data_index:
                self.spatial_group = g

    @property
    def coords(self):
        return (self.data_index, self.spatial_index)

    @property
    def is_main(self) -> bool:
        """Rank 0 (data 0, spatial 0): the rank that prints and writes."""
        return self.rank == 0

    def _group(self, axis: Optional[str]):
        return {None: self.group, "data": self.data_group,
                "spatial": self.spatial_group}[axis]

    # -- collectives (no autograd) ------------------------------------------

    def all_reduce_(self, t: torch.Tensor, axis: Optional[str] = None
                    ) -> torch.Tensor:
        """Sum ``t`` (contiguous) in place over the mesh, or over one axis."""
        group = self._group(axis)
        if self.stage:
            h = t.detach().cpu()
            dist.all_reduce(h, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=group)
        return t

    def sum(self, t: torch.Tensor, axis: Optional[str] = None
            ) -> torch.Tensor:
        """A new tensor: ``t`` summed over the mesh (or one axis), without
        gradient."""
        return self.all_reduce_(
            t.detach().clone(memory_format=torch.contiguous_format), axis)

    def all_gather(self, t: torch.Tensor, axis: Optional[str] = None
                   ) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on every rank) over the mesh or
        one axis, in rank order, on ``t``'s device."""
        group = self._group(axis)
        src = t.detach().contiguous()
        if self.stage:
            src = src.cpu()
        out = [torch.empty_like(src)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, src, group=group)
        return [o.to(t.device) for o in out] if self.stage else out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` (contiguous) on every rank, in place."""
        if self.stage:
            h = t.detach().cpu()
            dist.broadcast(h, 0)
            t.copy_(h)
        else:
            dist.broadcast(t, 0)
        return t

    def barrier(self) -> None:
        """Return once every rank has reached it (a summed token read back
        on the host, so it also orders what each rank did on the host
        before it, e.g. a file rank 0 wrote)."""
        self.sum(torch.zeros((), device=self.device)).item()

    # -- differentiable collectives ------------------------------------------

    def all_reduce_sum(self, x: torch.Tensor, axis: Optional[str] = None
                       ) -> torch.Tensor:
        """``x`` summed over the mesh (or one axis), differentiable: the
        backward sums the incoming gradients over the same ranks."""
        return _AllReduceSum.apply(x, self, axis)

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """The tensors summed over the mesh in one collective (one flat
        f32 buffer), each at its shape; no gradient."""
        flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
        self.all_reduce_(flat)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        return out

    def halo_exchange(self, x: torch.Tensor, top: int, bottom: int,
                      k: Optional[int] = None) -> torch.Tensor:
        """x (N, h, W, C) with ``top`` rows of the spatial rank above
        before it and ``bottom`` rows of the rank below after it (zeros
        above spatial rank 0 and below the last one). ``k``: the largest
        halo any spatial rank asks for this call, the same on every rank
        (by default max(top, bottom), which every rank must then share).
        The backward sends the gradient of the fetched rows back to their
        owner, which adds it to its own rows' gradient."""
        return _HaloExchange.apply(x, self, top, bottom,
                                   max(top, bottom) if k is None else k)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum(g, ctx.axis), None, None


def _edges(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 2k, W, C): x's first k rows, then its last k rows (a rank of
    fewer rows pads them with zeros: the first after, the last before)."""
    h = x.shape[1]
    m = min(k, h)
    z = x.new_zeros((x.shape[0], k - m) + tuple(x.shape[2:]))
    return torch.cat([x[:, :m], z, z, x[:, h - m:]], dim=1)


# gloo sums and gathers bf16, NCCL too; the halo's rows travel in their
# own dtype
class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, top, bottom, k):
        ctx.mesh, ctx.top, ctx.bottom, ctx.k = mesh, top, bottom, k
        ctx.h = x.shape[1]
        r, s = mesh.spatial_index, mesh.shape["spatial"]
        slabs = mesh.all_gather(_edges(x, k), "spatial")
        n, _, w, c = x.shape
        parts = []
        if top:
            parts.append(slabs[r - 1][:, 2 * k - top:] if r > 0
                         else x.new_zeros((n, top, w, c)))
        parts.append(x)
        if bottom:
            parts.append(slabs[r + 1][:, :bottom] if r < s - 1
                         else x.new_zeros((n, bottom, w, c)))
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh, top, bottom, k, h = ctx.mesh, ctx.top, ctx.bottom, ctx.k, ctx.h
        r, s = mesh.spatial_index, mesh.shape["spatial"]
        gx = g[:, top:top + h].clone()
        # the gradient of the rows taken from the rank above, aligned with
        # its last k rows, then of those from the rank below, aligned with
        # its first k rows
        ret = g.new_zeros((g.shape[0], 2 * k) + tuple(g.shape[2:]))
        if top:
            ret[:, k - top:k] = g[:, :top]
        if bottom:
            ret[:, k:k + bottom] = g[:, top + h:]
        rets = mesh.all_gather(ret, "spatial")
        m = min(k, h)
        if r < s - 1:
            gx[:, h - m:] += rets[r + 1][:, k - m:k]
        if r > 0:
            gx[:, :m] += rets[r - 1][:, k:k + m]
        return gx, None, None, None, None


# ---- the spatial axis: row ownership and the windowed ops ----------------------


def split_rows(height: int, parts: int) -> List[int]:
    """The row boundaries of ``parts`` spatial ranks over ``height`` rows:
    rank s owns [b[s], b[s + 1])."""
    return [height * s // parts for s in range(parts + 1)]


def local_rows(x: torch.Tensor, parts: int, index: int,
               dim: int = 1) -> torch.Tensor:
    """Rank ``index``'s rows of x along ``dim`` under :func:`split_rows`."""
    b = split_rows(x.shape[dim], parts)
    return x.narrow(dim, b[index], b[index + 1] - b[index])


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class SpatialRows:
    """The rows of one forward on the spatial axis. It holds the global
    heights of the forward's activations (the input's, then each windowed
    op's output's), so that an op finds its input's global height from
    the local one; every rank holds the same list, and a height whose
    local row counts would collide with another's on any rank is refused
    on every rank alike."""

    def __init__(self, mesh: Mesh, height: int):
        self.mesh = mesh
        self.parts = mesh.shape["spatial"]
        self.index = mesh.spatial_index
        self.heights: List[int] = []
        self.register(height)

    def _counts(self, height: int) -> List[int]:
        b = split_rows(height, self.parts)
        return [b[s + 1] - b[s] for s in range(self.parts)]

    def register(self, height: int) -> None:
        if height in self.heights:
            return
        counts = self._counts(height)
        if min(counts) < 1:
            raise ValueError(f"{height} rows cannot be split over "
                             f"{self.parts} spatial ranks")
        for g in self.heights:
            if any(a == b for a, b in zip(self._counts(g), counts)):
                raise ValueError(
                    f"activation heights {g} and {height} give one spatial "
                    f"rank the same row count; the spatial axis cannot "
                    f"tell them apart")
        self.heights.append(height)

    def global_height(self, local: int) -> int:
        for g in self.heights:
            if self._counts(g)[self.index] == local:
                return g
        raise ValueError(f"no activation of this forward has {local} rows "
                         f"on spatial rank {self.index}")

    def _extend(self, x: torch.Tensor, height: int, out_height: int,
                need: Callable[[int, int], tuple]) -> torch.Tensor:
        """x's rows widened to the global rows [lo, hi) that this rank's
        output rows need (``need(c, d)`` for output rows [c, d)), zeros
        outside the image. The geometry is computed for every rank alike,
        so all agree on the exchange."""
        ib, ob = split_rows(height, self.parts), split_rows(out_height,
                                                            self.parts)
        tops, bots = [], []
        for q in range(self.parts):
            if ob[q + 1] <= ob[q]:
                raise ValueError(f"{out_height} output rows cannot be split "
                                 f"over {self.parts} spatial ranks")
            lo, hi = need(ob[q], ob[q + 1])
            tops.append(ib[q] - lo)
            bots.append(hi - ib[q + 1])
            if (q > 0 and lo < 0) or (q < self.parts - 1 and hi > height) \
                    or (q > 0 and tops[q] > ib[q] - ib[q - 1]) \
                    or (q < self.parts - 1
                        and bots[q] > ib[q + 2] - ib[q + 1]):
                raise ValueError(
                    f"spatial rank {q} needs rows beyond its neighbours' "
                    f"at height {height}: too few rows a rank")
        k = max([0] + tops + bots)
        top, bot = tops[self.index], bots[self.index]
        if k:
            x = self.mesh.halo_exchange(x, max(top, 0), max(bot, 0), k)
        # a rank may own rows its outputs do not need (a strided op)
        start, stop = max(-top, 0), x.shape[1] - max(-bot, 0)
        return x[:, start:stop]

    def conv2d(self, x, w, b, stride, padding, dilation):
        """:func:`ops.nn.conv2d` on this rank's rows."""
        (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), \
            _pair(dilation)
        keff = dh * (w.shape[2] - 1) + 1
        height = self.global_height(x.shape[1])
        out_h = (height + 2 * ph - keff) // sh + 1
        xe = self._extend(x, height, out_h,
                          lambda c, d: (c * sh - ph, (d - 1) * sh - ph + keff))
        self.register(out_h)
        return nn.conv2d(xe, w, b, stride=(sh, sw), padding=(0, pw),
                         dilation=(dh, dw))

    def conv_transpose2d(self, x, w, b, stride, padding, output_padding):
        """:func:`ops.nn.conv_transpose2d` on this rank's rows: output row
        o sums input rows i with o + p = i * s + j, j < k."""
        (sh, sw), (ph, pw), (oh, ow) = _pair(stride), _pair(padding), \
            _pair(output_padding)
        kh = w.shape[2]
        if kh < sh:
            raise ValueError(f"a transposed conv of kernel {kh} < stride "
                             f"{sh} has no spatial form")
        height = self.global_height(x.shape[1])
        out_h = (height - 1) * sh - 2 * ph + kh + oh
        ob = split_rows(out_h, self.parts)

        def need(c, d):
            return -(-(c + ph - kh + 1) // sh), (d - 1 + ph) // sh + 1

        lo = need(ob[self.index], ob[self.index + 1])[0]
        xe = self._extend(x, height, out_h, need)
        self.register(out_h)
        # the full transposed conv of rows [lo, hi): its row q is global
        # row q + lo * s - p of the output
        y = nn.conv_transpose2d(xe, w, b, stride=(sh, sw), padding=(0, pw),
                                output_padding=(0, ow))
        start = ob[self.index] + ph - lo * sh
        return y[:, start:start + ob[self.index + 1] - ob[self.index]]

    def max_pool(self, x, kernel, stride=None):
        """:func:`ops.nn.max_pool` (no padding) on this rank's rows."""
        (kh, kw) = _pair(kernel)
        (sh, sw) = _pair(stride if stride is not None else kernel)
        height = self.global_height(x.shape[1])
        out_h = (height - kh) // sh + 1
        xe = self._extend(x, height, out_h,
                          lambda c, d: (c * sh, (d - 1) * sh + kh))
        self.register(out_h)
        return nn.max_pool(xe, (kh, kw), (sh, sw))


@dataclasses.dataclass
class Context:
    """What a forward on a mesh reads (``layers.mesh_context``): the mesh,
    and on a spatial axis this forward's rows."""
    mesh: Mesh
    rows: Optional[SpatialRows]


def context(mesh: Mesh, height: Optional[int] = None) -> Context:
    """The forward context of ``mesh``; ``height``: the input's global
    height (needed on a spatial axis)."""
    if mesh.shape["spatial"] == 1:
        return Context(mesh, None)
    if height is None:
        raise ValueError("a forward on a spatial axis needs its input's "
                         "global height")
    return Context(mesh, SpatialRows(mesh, height))


# ---- the JAX module's API --------------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The (data x spatial) mesh over the default process group. A group
    the caller (or torchrun's environment) set up is kept; without one, a
    one-process group is made in this process. ``device``: this rank's
    device, ``cuda:LOCAL_RANK`` unless the caller names another; the
    group's backend follows it (NCCL for a card, gloo for the CPU)."""
    dev = _default_device() if device is None else resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    env = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ["WORLD_SIZE"]) if env else 1
    n = n_devices or world
    assert n % spatial == 0, f"{n} devices not divisible by spatial={spatial}"
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a process group of "
                         f"{n} ranks, not {world}")
    if not dist.is_initialized():
        if env:
            dist.init_process_group(_backend(dev))
        else:
            dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(n // spatial, spatial, dev)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a global array lies on the mesh: ``dims`` maps a dim to the
    mesh axis that splits it (the batch in contiguous blocks, the height
    by :func:`split_rows`); every other dim is whole on every rank."""
    mesh: Mesh
    dims: Mapping[int, str]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x``."""
        for dim, axis in self.dims.items():
            parts = self.mesh.shape[axis]
            index = self.mesh.data_index if axis == "data" \
                else self.mesh.spatial_index
            if axis == "data":
                if x.shape[dim] % parts:
                    raise ValueError(f"dim {dim} of {x.shape[dim]} is not "
                                     f"divisible by the mesh data axis "
                                     f"({parts})")
                size = x.shape[dim] // parts
                x = x.narrow(dim, index * size, size)
            else:
                x = local_rows(x, parts, index, dim)
        return x

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block ``y``."""
        for dim, axis in sorted(self.dims.items(), reverse=True):
            sizes = [int(s) for s in self.mesh.all_gather(
                torch.tensor([y.shape[dim]], device=y.device), axis)]
            pad = max(sizes) - y.shape[dim]
            if pad:
                shape = list(y.shape)
                shape[dim] = pad
                y = torch.cat([y, y.new_zeros(shape)], dim=dim)
            parts = self.mesh.all_gather(y, axis)
            y = torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                          dim=dim)
        return y


def batch_sharding(mesh: Mesh, spatial_dim: Optional[int] = 1) -> Sharding:
    """NHWC batch: N over ``data`` and (optionally) H over ``spatial``."""
    return Sharding(mesh, {0: "data"} if spatial_dim is None
                    else {0: "data", spatial_dim: "spatial"})


def label_sharding(mesh: Mesh, spatial_dim: Optional[int] = 1) -> Sharding:
    """(B, H, W) labels split as the batch."""
    return batch_sharding(mesh, spatial_dim)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, {})


def sample_sharding(mesh: Mesh) -> Sharding:
    """(B,) per-sample masks: data-parallel only."""
    return Sharding(mesh, {0: "data"})


def shard_batch(mesh: Mesh, imgs, targets, sample_mask, spatial: bool = True):
    """This rank's block of a global batch, with the canonical shardings.

    Raises a clear error when H is not divisible by the spatial axis:
    uneven spatial shards would silently degrade conv halo exchange and
    BN-stat balance, so the caller must pad (or pick a dividing factor).
    """
    sd = 1 if spatial else None
    n_sp = mesh.shape["spatial"]
    if spatial and imgs.shape[1] % n_sp != 0:
        raise ValueError(
            f"image height {imgs.shape[1]} is not divisible by the mesh "
            f"spatial axis ({n_sp}); pad H to a multiple of {n_sp} or use "
            f"spatial=False / a smaller spatial factor")
    if imgs.shape[0] % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch {imgs.shape[0]} is not divisible by the mesh data axis "
            f"({mesh.shape['data']}); pad the batch (sample_mask marks pad "
            f"rows) to a multiple of it")
    return (batch_sharding(mesh, sd).local(imgs),
            label_sharding(mesh, sd).local(targets),
            sample_sharding(mesh).local(sample_mask))


def replicate_state(mesh: Mesh, tree: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Rank 0's tensors on every rank (a broadcast, one a dtype)."""
    out = {}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for dtype, keys in by_dtype.items():
        flat = torch.cat([tree[k].detach().reshape(-1) for k in keys]) \
            .to(mesh.device).contiguous()
        mesh.broadcast_(flat)
        off = 0
        for k in keys:
            n = tree[k].numel()
            out[k] = flat[off:off + n].view(tree[k].shape).clone()
            off += n
    return {k: out[k] for k in tree}
