"""The port's utils/profiling.py against the JAX package's: the interval
union (overlaps once, gaps never), the analytic FLOPs report string for
string, ``device_busy_span_us`` None without a card, ``time_fn`` and
``device_trace`` on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from robocupvision_tpu.models import zoo as jzoo
from robocupvision_tpu.utils import profiling as jprofiling
from robocupvision_tpu_torch.export import torch_io
from robocupvision_tpu_torch.models import zoo
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


@pytest.mark.parametrize("kw,pruned", [(dict(), False),
                                       (dict(no_scale=True), True),
                                       (dict(pool=True, v2=True), True)])
def test_flops_report_equals_jax(kw, pruned):
    """The same report string from the same weights, carried from the
    port to the JAX package; a zeroed kernel shows with ``pruned``."""
    model = zoo.make("robo_unet", device="cpu",
                     generator=torch.Generator().manual_seed(2), **kw)
    state = model.state_dict()
    first = next(k for k in model.param_order if k.endswith("weight"))
    state[first].view(-1)[::2] = 0.0
    jmodel = jzoo.make("robo_unet", **kw)
    jparams = torch_io.to_jax_params(model.registry, state)
    got = profiling.flops_report(model, state, pruned)
    assert got == jprofiling.flops_report(jmodel, jparams, pruned)
    assert got.splitlines()[-1].startswith("  total   :")
    assert profiling.flops_report(model) == jprofiling.flops_report(jmodel)


def test_flops_report_other_family_equals_jax():
    model = zoo.make("pb_fcn", device="cpu")
    assert profiling.flops_report(model) \
        == jprofiling.flops_report(jzoo.make("pb_fcn")) \
        == "(no analytic FLOPs model for family pb_fcn)"


def test_device_busy_span_is_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ran = []
    assert profiling.device_busy_span_us(lambda: ran.append(1), 0) is None
    assert profiling.device_busy_span_us(lambda: ran.append(1), 1) is None


def test_time_fn_and_device_trace(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).random((64, 64),
                                                         dtype=np.float32))
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    secs = profiling.time_fn(fn, x, iters=5, warmup=2)
    assert secs > 0 and len(calls) == 7
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        fn(x)
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
