"""The port's utils/profiling.py against the JAX package's: the interval
union (overlaps once, gaps never), ``device_busy_span_us`` None without a
card, ``device_trace`` on the CPU (the tracer: test_torch_tracing.py)."""

import json
import os

import numpy as np
import pytest
import torch

from robocupvision_tpu.utils import profiling as jprofiling
from robocupvision_tpu_torch.utils import profiling


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10), (40, 50)], 20),              # a 30-unit gap counts never
    ([(0, 100), (10, 20), (30, 40)], 100),  # nested spans count once
    ([(0, 10), (5, 15)], 15),               # partial overlap merges
    ([], 0.0),
    ([(40, 50), (0, 10)], 20),              # unsorted input
    ([(0.5, 1.25), (1.25, 2.0), (3.0, 3.5)], 2.0),  # touching spans join
])
def test_interval_union_length_matches_jax(spans, busy):
    assert profiling.interval_union_length(spans) == busy
    assert jprofiling.interval_union_length(spans) == busy


def test_device_busy_span_is_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ran = []
    assert profiling.device_busy_span_us(lambda: ran.append(1), 0) is None
    assert profiling.device_busy_span_us(lambda: ran.append(1), 1) is None


def test_time_fn_and_device_trace(tmp_path):
    """``device_trace`` writes the block's Chrome trace (the name kept from
    when the test also timed ``time_fn``, which is gone)."""
    x = torch.from_numpy(np.random.default_rng(0).random((64, 64),
                                                         dtype=np.float32))
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        x @ x
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
