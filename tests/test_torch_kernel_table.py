"""The table of the port's hand-written kernels (gmix_tpu_torch/ops/kernels.py)
against csrc/ and against the package that reads it: the C entries and
argument structures, the names launches are counted under, the launches a
byte step makes, and the wrappers' refusal of CPU tensors.

Imports torch and gmix_tpu_torch only; no test needs a card."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch import bench, obs
from gmix_tpu_torch.core import contexts, inputs, lstm, ppm
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.core.step import StepPlan
from gmix_tpu_torch.ops import kernels
from gmix_tpu_torch.utils import contexts_inputs, inputs_inputs, lstm_inputs, ppm_inputs

PKG = Path(gt.__file__).parent
CSRC = PKG / "csrc"


def _c_entries():
    """Every `gmix_*` function inside an `extern "C"` block of csrc/*.cu, by
    file."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for block in re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', src.read_text(), re.S):
            out.update({name: src.name for name in re.findall(r"^\S[^(\n]*?\b(gmix_\w+)\(", block, re.M)})
    return out


def _c_fields(source: str, struct: str):
    body = re.search(rf"struct {struct} \{{(.*?)\}};", (CSRC / source).read_text(), re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            ctype, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl).groups()
            fields += [(n.strip(), ctype) for n in names.split(",")]
    return fields


STRUCTS = {k.struct.__name__: (k.source, k.struct) for k in kernels.KERNELS if k.struct is not None}


@pytest.mark.parametrize("struct", sorted(STRUCTS))
def test_kernel_arguments_are_the_c_structs(struct):
    """Each ctypes structure of the table declares its C structure field for
    field: the names, in order, pointers first, then the int64 sizes, then
    the floats."""
    source, py = STRUCTS[struct]
    kinds = {ctypes.c_void_p: "*", ctypes.c_int64: "int64_t", ctypes.c_float: "float"}
    fields = [(n, kinds[t]) for n, t in py._fields_]
    c_fields = _c_fields(source, struct)
    assert [n for n, _ in c_fields] == [n for n, _ in fields]
    for (_, ctype), (name, kind) in zip(c_fields, fields):
        assert ctype.endswith("*") if kind == "*" else ctype == kind, name


def test_every_c_entry_has_a_row():
    """The library's C entries are the table's: each kernel's entry and
    prepare entry, and `OTHER_ENTRIES`; none more, none fewer."""
    table = {k.entry for k in kernels.KERNELS} | {k.prepare for k in kernels.KERNELS if k.prepare}
    assert len(_c_entries()) == 20
    assert set(_c_entries()) == table | set(kernels.OTHER_ENTRIES)


def test_every_row_is_in_its_source():
    """Each row's entry and prepare entry are in its source, and its kernel
    (the name a trace shows) is a `__global__` function of that source or a
    header it includes."""
    entries = _c_entries()
    for k in kernels.KERNELS:
        assert entries[k.entry] == k.source, k.name
        assert k.prepare is None or entries[k.prepare] == k.source, k.name
        text = (CSRC / k.source).read_text()
        text += "".join((CSRC / h).read_text() for h in re.findall(r'#include "(\w+\.cuh)"', text))
        assert re.search(rf"^__global__ void\b.*\b{k.name}\(", text, re.M), k.name
    assert len({w for k in kernels.KERNELS for w in k.wrappers}) == sum(len(k.wrappers) for k in kernels.KERNELS)


def test_no_other_python_file_names_a_c_entry():
    root = PKG.parent
    files = [*PKG.rglob("*.py"), *root.glob("*.py"), *(root / "tools").glob("*.py"), *(root / "tests").glob("*.py")]
    names = re.compile(r"\b(" + "|".join(_c_entries()) + r")\b")
    assert [str(f) for f in files if f.name != "kernels.py" and names.search(f.read_text())] == []


def test_every_counted_name_is_a_wrapper_of_the_table():
    """Launches are counted in ops/kernels.py alone, under the wrapper name
    each call passes; every name the package passes is a wrapper of the
    table, and every wrapper is passed somewhere."""
    counted, passed = [], set()
    for f in PKG.rglob("*.py"):
        text = f.read_text()
        if "obs.launched(" in text:
            counted.append(f.relative_to(PKG).as_posix())
        passed |= set(re.findall(r'\b(?:kernels\.launch|kernels\.call|_launch|_gather_launch)\(\s*"(\w+)"', text))
    assert counted == ["ops/kernels.py"]
    assert passed == set(kernels.BY_WRAPPER)


def test_call_refuses_a_name_outside_the_table():
    """A launch is counted only under a wrapper of the table: `call` refuses
    any other name before it loads the library or launches anything."""
    before = obs.launches()
    with pytest.raises(ValueError, match="not a wrapper of a kernel of the table"):
        kernels.call("gather_row", torch.device("cuda", 0))
    assert obs.launches() == before


SPECS = {"ref-full": lambda: bench.spec_for(None), "best": gt.best_spec, "ref-ppm": bench.ref_ppm_spec,
         "ref-noppm": bench.ref_noppm_spec, "ref:ablate-nomatch": lambda: bench.parse_profile("ref:ablate-nomatch")[1]}


@pytest.mark.parametrize("name,sampling,total,want", [
    ("ref-full", False, 13, (3, 2, 1, 1, 1, 1, 1, 1, 1, 1)), ("best", False, 13, (3, 2, 1, 1, 1, 1, 1, 1, 1, 1)),
    ("ref-ppm", False, 10, (2, 2, 1, 1, 1, 1, 1, 0, 0, 1)), ("ref-noppm", False, 6, (1, 1, 1, 0, 0, 1, 1, 0, 0, 1)),
    ("ref-full", True, 11, (3, 1, 1, 1, 1, 1, 1, 1, 0, 1)), ("ref-ppm", True, 9, (2, 1, 1, 1, 1, 1, 1, 0, 0, 1)),
    ("ref-noppm", True, 5, (1, 0, 1, 0, 0, 1, 1, 0, 0, 1)),
    ("ref:ablate-nomatch", False, 12, (3, 2, 1, 1, 1, 1, 0, 1, 1, 1)),
])
def test_launches_per_step(name, sampling, total, want):
    """A byte step launches 13 / 13 / 10 / 6 kernels at ref-full / best /
    ref-ppm / ref-noppm, a sampling step 11 / 9 / 5 (no byte-end scatter, no
    output-layer SGD), a spec without match models no match kernel, and every
    step one inputs kernel: by kernel in the table's order, and counted by
    wrapper the same way."""
    got = kernels.launches_per_step(SPECS[name](), sampling)
    assert got == want and sum(got) == total
    assert kernels.launch_counts({k.wrappers[-1]: n for k, n in zip(kernels.KERNELS, got)}) == got


def _cpu_call(wrapper):
    """A call of the kernel function that `wrapper` counts, on CPU tensors of
    the tiny spec with PPM and the LSTM."""
    meta = build_meta(gt.tiny_spec(True))
    plan = StepPlan(meta, 2, "cpu")
    if wrapper.startswith("ppm"):
        sp = meta.spec.ppm
        t = {k: torch.as_tensor(v.view(np.int16) if v.dtype == np.uint16 else v)
             for k, v in ppm_inputs.random_inputs(len(sp.orders), sp.see_buckets, 2, 1).items()}
        if wrapper == "ppm_update":
            return lambda: ppm.ppm_update_kernel(t["raw"], t["cv"], t["completed"], t["see"], plan)
        return lambda: ppm.ppm_predict_kernel(t["raw"], t["cv"], t["see"], plan)
    if wrapper == "inputs_pack":
        state, args = inputs_inputs.to_state(inputs_inputs.random_sample(meta, 2, 1, "decode"), "cpu")
        return lambda: inputs.inputs_kernel(state, plan=plan, **args)
    if wrapper in ("contexts_boundary", "match_pointer"):
        stm, ltm = contexts_inputs.to_state(meta, contexts_inputs.random_state(meta, 2, 3), "cpu")
        if wrapper == "contexts_boundary":
            return lambda: contexts.boundary_kernel(stm, torch.tensor(1), plan)
        return lambda: contexts.match_kernel(stm, ltm, plan)
    stm, ltm = lstm_inputs.to_state(lstm_inputs.random_state(meta, 2, 1, 3), "cpu")
    lp = lstm.LstmPlan(meta.spec.lstm, 2, "cpu")
    if wrapper == "lstm_forward":
        return lambda: lstm.lstm_forward_kernel(stm, ltm, lp, int(meta.slots["lstm_ctx"]))
    return lambda: lstm.lstm_perceive_kernel(stm, ltm, stm["acc"], lp, True)


@pytest.mark.parametrize("wrapper", [k.wrappers[0] for k in kernels.KERNELS if k.struct is not None])
def test_kernels_refuse_cpu_tensors(wrapper):
    """The kernels' functions take CUDA tensors only (the byte step sends
    CPU tensors to the plain versions), with one message for every kernel,
    and count no launch."""
    call = _cpu_call(wrapper)
    before = obs.launches()
    with pytest.raises(ValueError, match=re.escape(kernels.NOT_CUDA)):
        call()
    assert obs.launches() == before
