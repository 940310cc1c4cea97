"""A configuration's `spec_builder` is read by name (counts.spec_builder):
the port's spec builders with int literal arguments are taken, anything
else is refused with ValueError, so that a configuration joins the
benchmark by its files alone."""
import pytest

from gmix_tpu_torch import bench, config
from h100_bench.counts import spec_builder


@pytest.mark.parametrize("text,want", [
    ("gmix_tpu_torch.config.reference_spec()", config.reference_spec),
    ("gmix_tpu_torch.config.best_spec()", config.best_spec),
    ("gmix_tpu_torch.bench.ref_noppm_spec()", bench.ref_noppm_spec),
    ("gmix_tpu_torch.bench.spec_for(11)", lambda: bench.spec_for(11)),
], ids=["reference", "best", "ref-noppm", "scaled11"])
def test_the_ports_builders_are_taken(text, want):
    assert spec_builder(text).stable_hash() == want().stable_hash()


@pytest.mark.parametrize("text", [
    "gmix_tpu.config.reference_spec()",  # the JAX package: the leading name compared whole
    "gmix_tpu_torchx.config.reference_spec()",
    "os.system()",
    "gmix_tpu_torch.bench.spec_for(x)",  # not a literal
    "gmix_tpu_torch.bench.spec_for(__import__('os').getpid())",
    "gmix_tpu_torch.bench.spec_for(11.0)",
    "gmix_tpu_torch.bench.spec_for(None)",
    "gmix_tpu_torch.bench.spec_for(True)",
    "gmix_tpu_torch.config.reference_spec",  # no call
    "gmix_tpu_torch.config.reference_spec() ",
    "reference_spec()",
    "gmix_tpu_torch.config.no_such_spec()",
    "gmix_tpu_torch.no_such_module.reference_spec()",
    "gmix_tpu_torch.bench.padded_per(1, 1, 1)",  # a function of the port that gives no spec
], ids=["jax-package", "other-package", "os-system", "name-argument", "call-argument", "float-argument",
        "none-argument", "bool-argument", "missing-parens", "trailing-space", "bare-name", "no-function", "no-module", "not-a-spec"])
def test_anything_else_is_refused(text):
    with pytest.raises(ValueError, match="spec_builder"):
        spec_builder(text)
