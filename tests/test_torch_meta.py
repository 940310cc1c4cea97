"""gmix_tpu_torch's carried-over config, meta and tables against gmix_tpu's:
the spec hash (written into every archive header), every Meta field, and the
state-machine tables must be identical."""
import dataclasses

import numpy as np
import pytest

import gmix_tpu.config as j_cfg
import gmix_tpu_torch.config as t_cfg
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu.ops import tables as j_tables
from gmix_tpu_torch.core.meta import build_meta as t_build_meta
from gmix_tpu_torch.ops import tables as t_tables


def ref_noppm(cfg):
    """The reference wiring with bench.py's two APM stages, without PPM and
    LSTM (the spec chip_smoke.py runs)."""
    return dataclasses.replace(
        cfg.reference_spec(),
        apm=(
            cfg.ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
            cfg.ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
        ),
        ppm=None,
        lstm=None,
        roll_ctxs=(),
    )


def ref_full(cfg):
    """The whole reference wiring (PPM and the LSTM) with bench.py's two APM
    stages: the widest spec chip_smoke.py runs."""
    return dataclasses.replace(cfg.reference_spec(), apm=ref_noppm(cfg).apm)


SPECS = {
    "tiny": lambda c: c.tiny_spec(False),
    "tiny_lstm": lambda c: c.tiny_spec(True),
    "reference": lambda c: c.reference_spec(),
    "best": lambda c: c.best_spec(),
    "ref_noppm": ref_noppm,
    "ref_noppm_scaled12": lambda c: c.scale_tables(ref_noppm(c), 12, history_bits=16),
    "ref_full": ref_full,
    "ref_full_scaled12": lambda c: c.scale_tables(ref_full(c), 12, history_bits=16),
    "best_scaled8": lambda c: c.scale_tables(c.best_spec(), 8, history_bits=10),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_stable_hash_equal(name):
    j_spec, t_spec = SPECS[name](j_cfg), SPECS[name](t_cfg)
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    assert t_spec.stable_hash() == j_spec.stable_hash()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_meta_fields_equal(name):
    jm, tm = j_build_meta(SPECS[name](j_cfg)), t_build_meta(SPECS[name](t_cfg))
    j_fields = [f.name for f in dataclasses.fields(jm)]
    assert [f.name for f in dataclasses.fields(tm)] == j_fields
    for field in j_fields:
        a, b = getattr(jm, field), getattr(tm, field)
        if field == "spec":
            assert b.stable_hash() == a.stable_hash()
        elif isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype, field
            assert np.array_equal(a, b), field
        else:
            assert type(b) is type(a) and b == a, field


def test_tables_equal():
    for fn in ("nonstationary_table", "run_map_table"):
        a, b = getattr(j_tables, fn)(), getattr(t_tables, fn)()
        assert b.dtype == a.dtype and np.array_equal(a, b), fn
