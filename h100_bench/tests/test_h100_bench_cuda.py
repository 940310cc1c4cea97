"""On the card: a run of the harness at a tiny spec reads correct, with a
trace whose device busy time lies inside its window. Skips without a CUDA
device (decided inside the test)."""
import time

import pytest
import torch

from h100_bench import registry
from h100_bench.check import correct
from h100_bench.harness import run_cell
from test_h100_bench_faults import MIX, SEED, tiny_config


@pytest.mark.cuda
def test_tiny_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_cell(tiny_config(), MIX, SEED, 1.0, True, "cuda:0", time.perf_counter(), settle_s=0.0)
    assert correct(out["verdict"]["numbers"], out["failed"]), out["verdict"]
    t = out["run"].trace
    assert 0 < t.busy_ns() <= t.window_ns
    assert registry.metric_reader("kernels_per_step.enc")(out["run"]) > 0
