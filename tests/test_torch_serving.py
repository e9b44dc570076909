"""The port's ServingPipeline keeps submission order and its window size."""

import numpy as np
import pytest
import torch

from robocupvision_tpu_torch.utils.serving import ServingPipeline


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_returns_results_in_order(depth):
    seen = []

    def device_fn(x):
        seen.append(int(x[0]))
        return (x * 10, {"id": x[:1]})

    pipe = ServingPipeline(device_fn, depth=depth, device="cpu",
                           host_postprocess=lambda out: int(out[1]["id"][0]))
    frames = [np.array([i, i], np.int64) for i in range(7)]
    got = []
    for i, f in enumerate(frames):
        r = pipe.submit(f)
        assert len(pipe) == min(i + 1, depth)
        assert (r is None) == (i < depth)
        if r is not None:
            got.append(r)
    got += pipe.flush()
    assert got == list(range(7)) and seen == list(range(7))
    assert len(pipe) == 0
    assert list(ServingPipeline(lambda x: x + 1, depth=depth, device="cpu")
                .map(torch.arange(5))) == [torch.tensor(i + 1) for i in range(5)]
