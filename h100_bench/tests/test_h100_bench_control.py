"""The control comes out not correct: the reference with its state held in
bfloat16 (the next precision below the spec's float32), standing as the
program's archive, fails the run's own comparison on every seed, at a size
a test run holds. On the card's machine `python3 -m h100_bench.control`
reads the same at each cell's own size."""
import pytest

from h100_bench import control
from h100_bench.check import LIMITS
from test_h100_bench_faults import MIX, tiny_config, tiny_noppm_config


@pytest.mark.parametrize("seed", [11, 2_147_483_659, 4_000_000_007])
def test_control_fails(seed):
    _control_fails(tiny_config(), seed)


@pytest.mark.parametrize("seed", [13, 2_147_483_693, 4_000_000_009])
def test_control_fails_without_lstm_and_ppm(seed):
    _control_fails(tiny_noppm_config(), seed)


def _control_fails(config, seed):
    got = control.reading(config, MIX, seed)
    assert got["reference_code_bytes"] > 0 and got["control_code_bytes"] > 0
    assert got["checks"]["archive_mismatch_bytes"]["value"] > LIMITS["archive_mismatch_bytes"]
    assert got["correct"] is False
