"""Software-pipelined serving loop over CUDA tensors.

CUDA launches are asynchronous: ``device_fn(frame)`` returns tensors whose
kernels are queued on the current stream, and only the fetch (``.cpu()``)
waits for them. ``ServingPipeline`` keeps up to ``depth`` frames in flight,
so frame t's readback overlaps the queueing and compute of the frames after
it, while results still come back strictly in submission order.

While the tracer records (utils/profiling.py), each batch's submit and
fetch are spans, and on the card a fetch first waits for an event recorded
after the batch's work (``serve.fetch_wait``) and only then copies; while
it does not, no event is made.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from robocupvision_tpu_torch.device import DeviceLike, resolve_device
from robocupvision_tpu_torch.utils import profiling


def _fetch_tree(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(_fetch_tree(o) for o in out)
    if isinstance(out, dict):
        return {k: _fetch_tree(v) for k, v in out.items()}
    return out


class ServingPipeline:
    """Keep up to ``depth`` inference calls in flight, returning results in
    submission order.

    ``device_fn``: frame tensor (on ``device``) -> output tensors.
    ``host_postprocess``: optional host-side fn applied to the fetched
    result (e.g. ``PackedInfer.infer_u8_packed``'s numpy unpack).
    ``device``: where frames are sent, ``cuda`` unless the caller passes
    another; host frames are copied there before ``device_fn`` sees them.
    """

    def __init__(self, device_fn: Callable, *,
                 host_postprocess: Optional[Callable] = None, depth: int = 2,
                 device: DeviceLike = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.device_fn = device_fn
        self.host_postprocess = host_postprocess
        self.depth = depth
        self._inflight: deque = deque()   # (number, output, done event)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._inflight)

    def _fetch(self) -> Any:
        seq, out, done = self._inflight.popleft()
        with profiling.span("serve.fetch", req=seq):
            if done is not None:
                with profiling.span("serve.fetch_wait"):
                    done.synchronize()
            out = _fetch_tree(out)
            if self.host_postprocess is not None:
                out = self.host_postprocess(out)
        return out

    def submit(self, frame) -> Optional[Any]:
        """Dispatch ``frame``; if the pipeline is full, block on (and return)
        the OLDEST in-flight result, else return None. The first ``depth``
        submissions therefore return None: drain with :meth:`flush`."""
        seq = self._seq
        self._seq += 1
        with profiling.span("serve.submit", req=seq):
            with profiling.span("serve.copy_in"):
                x = torch.as_tensor(frame).to(self.device, non_blocking=True)
            with profiling.span("serve.enqueue"):
                out = self.device_fn(x)
            done = None
            if x.is_cuda and profiling.recording():
                done = torch.cuda.Event()
                done.record()
            self._inflight.append((seq, out, done))
            if len(self._inflight) > self.depth:
                return self._fetch()
        return None

    def flush(self) -> list:
        """Fetch every remaining in-flight result, oldest first."""
        out = []
        while self._inflight:
            out.append(self._fetch())
        return out

    def map(self, frames: Iterable) -> Iterator:
        """Stream ``frames`` through the pipeline, yielding one result per
        frame in order."""
        for frame in frames:
            got = self.submit(frame)
            if got is not None:
                yield got
        yield from self.flush()
