"""The CUDA kernels (row movers, the fused 8-sub-step kernel) against their
plain torch versions, on a GPU.

Imports torch and gmix_tpu_torch only, so it runs on a GPU machine that has
no JAX: `python -m pytest tests/test_torch_kernels.py -q`. Without a CUDA
device every test skips (the kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

from gmix_tpu_torch import obs
from gmix_tpu_torch.ops import rowmove


def _launches(kernel):
    """The launches of a hand-written kernel so far (by its wrapper's name)."""
    return obs.launches().get(kernel, 0)


# (dtype, row width) of the five arenas the byte step moves rows of:
# ind.st (u16 bits in int16), mix_w, mix_pos, apm, ppm_tbl (34 16-byte words)
SHAPES = [(torch.int16, 256), (torch.float32, 128), (torch.float32, 1024), (torch.float32, 264), (torch.int16, 272)]
S, N, M = 5, 300, 41


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sqrt_det_is_the_same_on_the_card_and_on_the_cpu(cuda):
    """`torch.sqrt` on float32 is not (the CPU's vectorised root is off by one
    ulp on about 0.7% of inputs); the LSTM's layer norm and Adam go through
    `sqrt_det` so that GPU and CPU archives stay equal."""
    from gmix_tpu_torch.ops.sigmoid import sqrt_det

    rng = np.random.default_rng(3)
    x = torch.tensor(np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 1_000_000)).astype(np.float32))
    assert torch.equal(sqrt_det(x.to(cuda)).cpu(), sqrt_det(x))


@pytest.mark.cuda
@pytest.mark.parametrize("bptt", [True, False], ids=["cond", "defer"])
def test_lstm_is_the_same_on_the_card_and_on_the_cpu(cuda, bptt):
    """An archive must be the same bits from either device: 25 byte-model
    steps (forward pass and byte end, csrc/lstm.cu's kernels on the card,
    the backward pass with Adam at every window wrap, in either order) from
    a seeded state, every LSTM leaf bit for bit."""
    import gmix_tpu_torch as gt
    from gmix_tpu_torch.core import lstm
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.state import init_state

    spec = gt.tiny_spec(True)
    meta = build_meta(spec)
    n_streams, horizon = 3, spec.lstm.horizon
    rng = np.random.default_rng(9)
    syms = rng.integers(0, 256, (25, n_streams))
    aux = rng.random((25, n_streams, 256)).astype(np.float32)
    aux /= aux.sum(axis=2, keepdims=True)
    states = {}
    for dev in (torch.device("cpu"), cuda):
        st = init_state(meta, n_streams, device=dev)
        lp = lstm.LstmPlan(spec.lstm, n_streams, dev)
        for t in range(25):
            st["stm"]["ppm_probs"] = torch.as_tensor(aux[t], device=dev)
            lstm._lstm_forward(st["stm"], st["ltm"], lp, int(meta.slots["lstm_ctx"]))
            e_cur = (t + 1) % horizon
            lstm._lstm_perceive(st["stm"], st["ltm"], torch.as_tensor(syms[t], device=dev), lp, e_cur == 0, bptt)
            if not bptt and e_cur == 0:
                lstm._lstm_bptt(st["stm"]["lstm"], st["ltm"]["lstm"], lp)
            st["stm"]["last_byte"] = torch.as_tensor(syms[t], device=dev)
        states[dev.type] = {**{"stm." + k: v for k, v in st["stm"]["lstm"].items()},
                            **{"ltm." + k: v for k, v in st["ltm"]["lstm"].items()}}
    assert int(states["cpu"]["stm.update_steps"]) == 2
    for k, a in states["cpu"].items():
        assert torch.equal(a, states["cuda"][k].cpu()), k


def _fill(t, gen):
    return t.normal_(generator=gen) if t.is_floating_point() else t.random_(generator=gen)


def _case(dtype, W, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbl = _fill(torch.empty((S, N, W), dtype=dtype, device=dev), gen)
    upd = _fill(torch.empty((S, M, W), dtype=dtype, device=dev), gen)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(N, M, replace=False) for _ in range(S)]).astype(np.int32)
    return tbl, torch.as_tensor(idx, device=dev), upd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,W", SHAPES)
def test_gather_kernel_matches_plain(cuda, dtype, W):
    tbl, idx, _ = _case(dtype, W, cuda, W)
    n0 = _launches("gather_rows")
    got = rowmove.gather_rows(tbl, idx)
    assert _launches("gather_rows") == n0 + 1
    assert torch.equal(got, rowmove.gather_rows_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,W", SHAPES)
def test_scatter_kernel_matches_plain(cuda, dtype, W):
    tbl, idx, upd = _case(dtype, W, cuda, W + 1)
    ref = tbl.clone()
    n0 = _launches("scatter_rows")
    assert rowmove.scatter_rows(tbl, idx, upd) is tbl
    assert _launches("scatter_rows") == n0 + 1
    rowmove.scatter_rows_plain(ref, idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(tbl, ref)


def _arena(dtype, W, n_rows, m, dev, seed, streams=S):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbl = _fill(torch.empty((streams, n_rows, W), dtype=dtype, device=dev), gen)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n_rows, m, replace=False) for _ in range(streams)]).astype(np.int32)
    return tbl, torch.as_tensor(idx, device=dev)


# (dtype, row width, table rows, rows gathered per stream): the byte step's
# four shapes, a 4 KB row that takes a whole block, and S * M values (S = 5)
# that are no multiple of the 8, 4, 2 or 1 rows a block moves
GROUP_ARENAS = [
    (torch.int16, 256, 300, 41), (torch.float32, 128, 300, 20), (torch.float32, 1024, 64, 2),
    (torch.float32, 264, 90, 2), (torch.float32, 256, 50, 3), (torch.int32, 4, 40, 7),
    (torch.float32, 512, 33, 1), (torch.int16, 2048, 17, 3),
]
# the byte step's five arenas with PPM: the first four and 9 rows of 272 u16
PPM_GROUP = GROUP_ARENAS[:4] + [(torch.int16, 272, 500, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_arenas", [1, 4, 8])
def test_grouped_gather_kernel_matches_plain(cuda, n_arenas):
    pairs = [_arena(dt, W, n, m, cuda, 100 + i) for i, (dt, W, n, m) in enumerate(GROUP_ARENAS[:n_arenas])]
    n0 = _launches("gather_rows_many")
    got = rowmove.gather_rows_many(pairs)
    torch.cuda.synchronize()
    assert _launches("gather_rows_many") == n0 + 1  # one launch, whatever the number of arenas
    want = rowmove.gather_rows_many_plain(pairs)
    assert len(got) == n_arenas
    for a, b in zip(want, got):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_grouped_gather_kernel_takes_the_ppm_rows(cuda):
    pairs = [_arena(dt, W, n, m, cuda, 300 + i) for i, (dt, W, n, m) in enumerate(PPM_GROUP)]
    n0 = _launches("gather_rows_many")
    got = rowmove.gather_rows_many(pairs)
    torch.cuda.synchronize()
    assert _launches("gather_rows_many") == n0 + 1
    for a, b in zip(rowmove.gather_rows_many_plain(pairs), got):
        assert (a.shape, a.dtype) == (b.shape, b.dtype) and torch.equal(a, b)


def _scatter_group(arenas, dev, seed0):
    triples = []
    for i, (dt, W, n, m) in enumerate(arenas):
        tbl, idx = _arena(dt, W, n, m, dev, seed0 + i)
        upd = _fill(torch.empty((S, m, W), dtype=dt, device=dev), torch.Generator(device=dev).manual_seed(seed0 + 50 + i))
        triples.append((tbl, idx, upd))
    return triples


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["1", "4", "8", "ppm"])
def test_grouped_scatter_kernel_matches_plain(cuda, group):
    """Every table of the group after ONE launch equals a copy after the
    plain scatter, whole tables compared: no row but the indexed ones moved."""
    arenas = PPM_GROUP if group == "ppm" else GROUP_ARENAS[: int(group)]
    triples = _scatter_group(arenas, cuda, 400)
    refs = [(tbl.clone(), idx, upd) for tbl, idx, upd in triples]
    n0, n1 = _launches("scatter_rows_many"), _launches("scatter_rows")
    got = rowmove.scatter_rows_many(triples)
    torch.cuda.synchronize()
    assert _launches("scatter_rows_many") == n0 + 1  # one launch, whatever the number of arenas
    assert _launches("scatter_rows") == n1
    want = rowmove.scatter_rows_many_plain(refs)
    torch.cuda.synchronize()
    assert len(got) == len(arenas)
    for (tbl, _, _), out, ref in zip(triples, got, want):
        assert out is tbl and torch.equal(tbl, ref)


@pytest.mark.cuda
def test_grouped_scatter_rejects_what_the_kernel_does_not_take(cuda):
    tbl, idx, upd = _scatter_group(GROUP_ARENAS[1:2], cuda, 1)[0]
    kept = tbl.clone()
    with pytest.raises(ValueError, match="1 to 8 arenas"):
        rowmove.scatter_rows_many([(tbl, idx, upd)] * 9)
    with pytest.raises(ValueError, match="one device"):
        rowmove.scatter_rows_many([(tbl, idx, upd), (tbl.cpu(), idx.cpu(), upd.cpu())])
    with pytest.raises(ValueError, match="int32"):
        rowmove.scatter_rows_many([(tbl, idx.long(), upd)])
    with pytest.raises(ValueError, match="rows is .* torch.float64"):
        rowmove.scatter_rows_many([(tbl, idx, upd.double())])
    with pytest.raises(ValueError, match=r"rows is \(5, 1, 128\)"):
        rowmove.scatter_rows_many([(tbl, idx, upd[:, :1])])
    with pytest.raises(ValueError, match="contiguous"):
        rowmove.scatter_rows_many([(tbl, idx, upd.transpose(0, 1).contiguous().transpose(0, 1))])
    assert rowmove.scatter_rows_many([]) == []
    torch.cuda.synchronize()
    assert torch.equal(tbl, kept)  # a rejected call wrote nothing


@pytest.mark.cuda
def test_grouped_gather_rejects_what_the_kernel_does_not_take(cuda):
    pair = _arena(torch.float32, 128, 50, 3, cuda, 1)
    with pytest.raises(ValueError, match="1 to 8 arenas"):
        rowmove.gather_rows_many([pair] * 9)
    with pytest.raises(ValueError, match="one device"):
        rowmove.gather_rows_many([pair, (pair[0].cpu(), pair[1].cpu())])
    with pytest.raises(ValueError, match="int32"):
        rowmove.gather_rows_many([pair, (pair[0], pair[1].long())])
    assert rowmove.gather_rows_many([]) == []


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    tbl, idx, upd = _case(torch.float32, 128, cuda, 7)
    with pytest.raises(ValueError, match="int32"):
        rowmove.gather_rows(tbl, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        rowmove.gather_rows(tbl[:, :, :64], idx)
    with pytest.raises(ValueError, match="indices is .* on cpu"):
        rowmove.scatter_rows(tbl, idx.cpu(), upd)
    with pytest.raises(ValueError, match="multiple of 16"):
        rowmove.gather_rows(torch.zeros((S, N, 6), device=cuda), idx)


# ---------------------------------------------------------------------------
# the fused 8-sub-step kernel (csrc/fused.cu) against its plain version
# ---------------------------------------------------------------------------


def _ref_noppm_spec():
    import dataclasses

    from gmix_tpu_torch.config import ApmStage, reference_spec

    return dataclasses.replace(
        reference_spec(),
        apm=(ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
             ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25)),
        ppm=None, lstm=None, roll_ctxs=(),
    )


def _more_indirects(spec, times):
    """The spec with every indirect model `times` times over: a wider mixer
    row and larger look-up tables."""
    import dataclasses

    ind = tuple(dataclasses.replace(m, name=f"{m.name}_{r}") for r in range(times) for m in spec.indirects)
    return dataclasses.replace(spec, indirects=ind)


def _fused_spec(name):
    import gmix_tpu_torch as gt

    import dataclasses

    return {"tiny": lambda: gt.tiny_spec(False), "tiny-heads": lambda: gt.tiny_spec(True),
            # the PPM head alone: the prediction columns shift by one
            "tiny-ppm": lambda: dataclasses.replace(gt.tiny_spec(True), lstm=None),
            "ref-ppm": lambda: dataclasses.replace(_ref_noppm_spec(), ppm=gt.reference_spec().ppm,
                                                   roll_ctxs=gt.reference_spec().roll_ctxs),
            "ref-noppm": _ref_noppm_spec, "reference": gt.reference_spec,
            # 256-lane rows (8 lane groups), layers of 6 and 2 rows, tables in shared memory
            "tiny-wide": lambda: _more_indirects(gt.tiny_spec(False), 10),
            # 256-lane rows, layers of 24 and 8 rows, 164 KB of p_tbl: tables stay in global memory
            "ref-wide": lambda: _more_indirects(_ref_noppm_spec(), 2)}[name]()


def _fused_case(spec_name, dev, learn, analysis, decode, streams=5):
    from gmix_tpu_torch.core import fused
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.utils.fused_inputs import random_inputs

    meta = build_meta(_fused_spec(spec_name))
    consts = fused.const_inputs(meta, learn, dev)
    inputs = random_inputs(meta, streams, 7 + int(decode), decode=decode, not_first=not decode)
    fin = {n: torch.as_tensor(inputs[n], device=dev)
           for n, _, _, kind in fused.io_layout(meta, learn, analysis)[0] if kind == "s"}
    return meta, consts, fin


def _assert_fused_equal(want, got):
    """Bitwise on every output that can reach an archive; `ent` and `ema` go
    through log2f / torch.log2, which need not agree to the bit: 16 ulp over
    the byte's 8 sub-steps and 1e-6 relative."""
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = want[name], got[name]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        if name == "ent":
            np.testing.assert_array_max_ulp(b.cpu().numpy(), a.cpu().numpy(), maxulp=16)
        elif name == "ema":
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a.contiguous().view(torch.uint8), b.view(torch.uint8)), f"{name} differs"


# the instantiations of the kernel a spec takes: (32-lane groups of a mixer
# row, look-up tables in shared memory)
INSTANTIATIONS = {"tiny": (4, True), "ref-noppm": (4, True), "reference": (4, True), "tiny-wide": (8, True),
                  "ref-wide": (8, False), "ref-ppm": (4, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("learn", [True, False])
@pytest.mark.parametrize("spec_name", ["tiny-wide", "ref-wide"])
def test_fused_kernel_other_instantiations_match_plain(cuda, spec_name, learn, decode):
    """Specs that take the kernel's other instantiations: 8 lane groups, the
    layer sizes without unrolled code (6 and 2), and look-up tables too large
    for shared memory."""
    from gmix_tpu_torch.core import fused

    meta, consts, fin = _fused_case(spec_name, cuda, learn, True, decode)
    inst = fused.fused_instantiation(meta, consts, learn, True, 5, cuda)
    assert (inst["lane_groups"], inst["tables_in_shared_memory"]) == INSTANTIATIONS[spec_name]
    assert 0 < inst["shared_bytes"] <= 232448
    got = fused.fused_substeps(meta, consts, fin, learn, True)
    torch.cuda.synchronize()
    _assert_fused_equal(fused.fused_substeps_plain(meta, consts, fin, learn, True), got)


@pytest.mark.cuda
def test_fused_kernel_opts_in_to_its_shared_memory_on_every_device(cuda):
    """Dynamic shared memory above 48 KB needs an opt-in that holds for the
    current device's context only: the reference spec's instantiation (more
    than 48 KB) and its clocks instantiation launch on every visible device
    in turn and equal the plain version there."""
    from gmix_tpu_torch.core import fused

    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        meta, consts, fin = _fused_case("reference", dev, True, True, False)
        assert fused.fused_instantiation(meta, consts, True, True, 5, dev)["shared_bytes"] > 48 * 1024
        got = fused.fused_substeps(meta, consts, fin, True, True)
        got_clocks, _ = fused.fused_substeps_clocks(meta, consts, fin, True, True)
        torch.cuda.synchronize(dev)
        want = fused.fused_substeps_plain(meta, consts, fin, True, True)
        _assert_fused_equal(want, got)
        _assert_fused_equal(want, got_clocks)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_name", ["tiny", "ref-noppm", "reference", "ref-ppm"])
def test_fused_instantiation_of_the_reference_specs(cuda, spec_name):
    from gmix_tpu_torch.core import fused

    meta, consts, _ = _fused_case(spec_name, cuda, True, True, False)
    inst = fused.fused_instantiation(meta, consts, True, True, 5, cuda)
    assert (inst["lane_groups"], inst["tables_in_shared_memory"]) == INSTANTIATIONS[spec_name]


@pytest.mark.cuda
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("spec_name", ["tiny", "ref-noppm", "ref-wide"])
def test_fused_clocks_instantiation_computes_the_same(cuda, spec_name, decode):
    """The kernel with stage clocks gives the outputs of the kernel without,
    bit for bit, `ent` and `ema` included, and does not count as a launch of
    the main path's kernel; every clock it is meant to store is stored."""
    from gmix_tpu_torch.core import fused

    meta, consts, fin = _fused_case(spec_name, cuda, True, True, decode)
    want = fused.fused_substeps(meta, consts, fin, True, True)
    n0 = _launches("fused_substeps")
    got, clk = fused.fused_substeps_clocks(meta, consts, fin, True, True)
    torch.cuda.synchronize()
    assert _launches("fused_substeps") == n0
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(want[name].view(torch.uint8), got[name].view(torch.uint8)), name
    assert clk.shape == (5, 8, len(fused.CLOCK_COLS)) and clk.dtype == torch.int64
    at = {n: i for i, n in enumerate(fused.CLOCK_COLS)}
    sub = [at[n] for n in fused.CLOCK_SUBSTEP + fused.CLOCK_SIDE]
    assert (clk[:, :, sub] > 0).all()
    assert (clk[:, 0, [at[n] for n in fused.CLOCK_LAUNCH]] > 0).all()
    assert (clk[:, 0, at["end"]] > clk[:, 0, at["start"]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("learn,analysis", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("spec_name", ["tiny", "tiny-heads", "ref-noppm", "reference", "tiny-ppm", "ref-ppm"])
def test_fused_kernel_matches_plain(cuda, spec_name, decode, learn, analysis):
    """Bitwise on every output that can reach an archive; `ent` and `ema` go
    through log2f / torch.log2, which need not agree to the bit: 16 ulp over
    the byte's 8 sub-steps and 1e-6 relative. Inputs are finite valid states."""
    from gmix_tpu_torch.core import fused
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.utils.fused_inputs import random_inputs

    meta = build_meta(_fused_spec(spec_name))
    streams = 5
    consts = fused.const_inputs(meta, learn, cuda)
    inputs = random_inputs(meta, streams, 7 + int(decode), decode=decode, not_first=not decode)
    fin = {n: torch.as_tensor(inputs[n], device=cuda)
           for n, _, _, kind in fused.io_layout(meta, learn, analysis)[0] if kind == "s"}
    kept = {n: v.clone() for n, v in fin.items()}
    n0 = _launches("fused_substeps")
    got = fused.fused_substeps(meta, consts, fin, learn, analysis)
    torch.cuda.synchronize()
    assert _launches("fused_substeps") == n0 + 1
    want = fused.fused_substeps_plain(meta, consts, fin, learn, analysis)
    assert sorted(got) == sorted(want) == sorted(n for n, _, _, _ in fused.io_layout(meta, learn, analysis)[1])
    for name in want:
        a, b = want[name], got[name]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        if name == "ent":
            np.testing.assert_array_max_ulp(b.cpu().numpy(), a.cpu().numpy(), maxulp=16)
        elif name == "ema":
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a.contiguous().view(torch.uint8), b.view(torch.uint8)), f"{name} differs"
    for n, v in fin.items():  # the kernel writes no input
        assert torch.equal(v, kept[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("analysis", [True, False])
@pytest.mark.parametrize("inv_temp", [1.0, 1.25, 1000.0], ids=["t1", "t0.8", "floor"])
@pytest.mark.parametrize("spec_name", ["tiny", "tiny-heads", "reference"])
def test_fused_kernel_sampling_matches_plain(cuda, spec_name, inv_temp, analysis):
    """The sampling mode (learn off): the bits drawn against the tempered
    probability and coded in encode mode, bitwise as in the plain version,
    the drawn byte in the coder's `acc` lane; one stream of the five encodes
    its data byte, as its `sc` says."""
    from gmix_tpu_torch.core import fused
    from gmix_tpu_torch.utils.fused_inputs import with_sampling

    meta, consts, fin = _fused_case(spec_name, cuda, False, analysis, False)
    fin = with_sampling(fin, 11, inv_temp, encode_streams=1)
    assert sorted(fin) == sorted(n for n, _, _, kind in fused.io_layout(meta, False, analysis, True)[0]
                                 if kind == "s" or n in fused.CALL_INPUTS)
    kept = {n: v.clone() for n, v in fin.items()}
    n0 = _launches("fused_substeps")
    got = fused.fused_substeps(meta, consts, fin, False, analysis, sample=True)
    torch.cuda.synchronize()
    assert _launches("fused_substeps") == n0 + 1
    want = fused.fused_substeps_plain(meta, consts, fin, False, analysis, sample=True)
    _assert_fused_equal(want, got)
    for n, v in fin.items():  # the kernel writes no input
        assert torch.equal(v, kept[n]), n
    # the encoding stream codes its data byte; the others their own draws
    acc = got["coder"][:, fused.CR_ACC]
    assert acc[-1].item() == fin["sc"][-1, fused.SC_DATA].item()
    with pytest.raises(ValueError, match="learn off"):
        fused.fused_substeps(meta, consts, fin, True, analysis, sample=True)


@pytest.mark.cuda
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    import gmix_tpu_torch as gt
    from gmix_tpu_torch.core import fused
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.utils.fused_inputs import random_inputs

    meta = build_meta(gt.tiny_spec(False))
    consts = fused.const_inputs(meta, True, cuda)
    fin = {n: torch.as_tensor(v, device=cuda) for n, v in random_inputs(meta, 2, 1).items()}
    with pytest.raises(ValueError, match="p_tbl is"):
        fused.fused_substeps(meta, consts, {**fin, "p_tbl": fin["p_tbl"].double()}, True, True)
    with pytest.raises(ValueError, match="rows_st is"):
        fused.fused_substeps(meta, consts, {**fin, "rows_st": fin["rows_st"][:, :1]}, True, True)
    with pytest.raises(ValueError, match="mt_pred is .* on cpu"):
        fused.fused_substeps(meta, consts, {**fin, "mt_pred": fin["mt_pred"].cpu()}, True, True)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_substeps(meta, consts, {**fin, "sc": fin["sc"].T.contiguous().T}, True, True)


# ---------------------------------------------------------------------------
# the PPM kernels (csrc/ppm.cu): count update and prediction
# ---------------------------------------------------------------------------

PPM_SPECS = ("gmix-ref", "gmix-best", "no-exclusion", "no-update-exclusion")


def _ppm_spec(name):
    import dataclasses

    import gmix_tpu_torch as gt

    spec = gt.best_spec() if name == "gmix-best" else gt.reference_spec()
    change = {"no-exclusion": {"exclusion": False}, "no-update-exclusion": {"update_exclusion": False}}.get(name, {})
    return dataclasses.replace(spec, ppm=dataclasses.replace(spec.ppm, **change))


def _ppm_plans(name, streams, dev):
    """The spec's step plans on the CPU and on `dev`: the kernels read only
    the PPM fields, the plain versions the plan's PPM constants."""
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.core.step import StepPlan

    meta = build_meta(_ppm_spec(name))
    return StepPlan(meta, streams, "cpu"), StepPlan(meta, streams, dev)


def _ppm_tensors(inputs, dev):
    return {k: torch.as_tensor(v.view(np.int16) if v.dtype == np.uint16 else v, device=dev) for k, v in inputs.items()}


def _bits_equal(a, b):
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    assert (a.shape, a.dtype) == (b.shape, b.dtype)
    return torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                       b.view(torch.int32) if b.dtype == torch.float32 else b)


def _check_ppm_kernels(name, inputs, dev):
    """Both kernels on `inputs` against the plain versions on the CPU and on
    the card, bit for bit: the rows to scatter, `ppm_see`, `ppm_probs`, top
    and bottom; one launch each, counted; no input written."""
    from gmix_tpu_torch.core import ppm

    S = inputs["cv"].shape[0]
    cpu_plan, plan = _ppm_plans(name, S, dev)
    host, t = _ppm_tensors(inputs, "cpu"), _ppm_tensors(inputs, dev)
    kept = {k: v.clone() for k, v in t.items()}
    n0 = (_launches("ppm_update"), _launches("ppm_predict"))
    got = {}
    got["rows"], got["see"] = ppm.ppm_update_rows(t["raw"], t["cv"], t["completed"], t["see"], plan)
    got["probs"], got["top"], got["bot"] = ppm.ppm_predict_probs(t["raw"], t["cv"], t["see"], plan)
    torch.cuda.synchronize()
    assert (_launches("ppm_update"), _launches("ppm_predict")) == (n0[0] + 1, n0[1] + 1)
    for k, v in t.items():
        assert torch.equal(v, kept[k]), k
    for where, tt, pl in (("cpu", host, cpu_plan), ("card", t, plan)):
        want = dict(zip(("rows", "see"), ppm.ppm_update_plain(tt["raw"], tt["cv"], tt["completed"], tt["see"], pl)))
        want.update(zip(("probs", "top", "bot"), ppm.ppm_predict_plain(tt["raw"], tt["cv"], tt["see"], pl)))
        for k in want:
            assert _bits_equal(got[k], want[k]), f"{k} differs from the plain version on the {where}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 54])
@pytest.mark.parametrize("name", PPM_SPECS)
def test_ppm_kernels_match_plain(cuda, name, streams):
    """Rows as the codec leaves them (sparse counts, a few large, tags of
    other contexts, padding lanes not zero, totals on both sides of the
    rescale), escape offsets with denormals and signed zeros; at the specs'
    own PPM settings."""
    from gmix_tpu_torch.utils.ppm_inputs import random_inputs

    sp = _ppm_spec(name).ppm
    for seed in range(3):
        _check_ppm_kernels(name, random_inputs(len(sp.orders), sp.see_buckets, streams, 100 * streams + seed), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PPM_SPECS)
def test_ppm_kernels_at_the_edges(cuda, name):
    """One stream per corner (`utils/ppm_inputs.py` `edge_inputs`): totals at
    rescale_total and one above after the increment, lanes at 65535, tags of
    other contexts, every symbol excluded (the 1/256 fallback), denormal and
    signed-zero offsets, empty rows, rows of 65535."""
    from gmix_tpu_torch.utils.ppm_inputs import EDGE_STREAMS, edge_inputs

    sp = _ppm_spec(name).ppm
    cv = np.random.default_rng(4).integers(0, 2**32, (len(EDGE_STREAMS), len(sp.orders)), dtype=np.int64)
    got = _check_ppm_kernels(name, edge_inputs(cv, sp.see_buckets, sp.inc, sp.rescale_total), cuda)
    s = EDGE_STREAMS.index("all-empty")
    assert (got["probs"][s] == 1 / 256).all()
    assert (got["top"] == 255).all() and (got["bot"] == 0).all()


@pytest.mark.cuda
def test_ppm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from gmix_tpu_torch.core import ppm
    from gmix_tpu_torch.utils.ppm_inputs import random_inputs

    _, plan = _ppm_plans("gmix-ref", 2, cuda)
    t = _ppm_tensors(random_inputs(9, 16, 2, 1), cuda)
    with pytest.raises(ValueError, match="cv is"):
        ppm.ppm_update_kernel(t["raw"], t["cv"].to(torch.int32), t["completed"], t["see"], plan)
    with pytest.raises(ValueError, match="see is"):
        ppm.ppm_predict_kernel(t["raw"], t["cv"], t["see"][:, :, :8].contiguous(), plan)
    with pytest.raises(ValueError, match="raw is"):
        ppm.ppm_predict_kernel(t["raw"].transpose(0, 1).contiguous().transpose(0, 1), t["cv"], t["see"], plan)
    with pytest.raises(ValueError, match="completed is"):
        ppm.ppm_update_kernel(t["raw"], t["cv"], t["completed"].cpu(), t["see"], plan)


# ---------------------------------------------------------------------------
# the contexts kernels (csrc/contexts.cu): boundary contexts and match pointers
# ---------------------------------------------------------------------------

# the benchmark's configurations and their cells' stream counts
CONTEXT_CELLS = {"gmix-ref": 54, "gmix-best": 30, "ref-noppm": 63}


def _contexts_meta(name):
    import gmix_tpu_torch as gt
    from gmix_tpu_torch import bench
    from gmix_tpu_torch.core.meta import build_meta

    return build_meta({"gmix-ref": gt.reference_spec, "gmix-best": gt.best_spec,
                       "ref-noppm": bench.ref_noppm_spec}[name]())


def _assert_leaves_equal(got, want, where, streams=None):
    assert sorted(got) == sorted(want)
    for k in want:
        a = got[k] if streams is None else got[k][streams]
        assert _bits_equal(a, want[k]), f"{k} differs from the plain version on the {where}"


def _check_contexts_kernels(meta, sample, dev, t):
    """Each kernel on a state of `sample` (the tables at full size on the
    card) against its plain version on the card, every stream, and on the
    CPU, on three streams' rows, bit for bit; one launch each, counted, and
    every leaf written in place. The match pointers run on a fresh state, so
    that they read the drawn table entries of its contexts."""
    from gmix_tpu_torch.core import contexts
    from gmix_tpu_torch.core.step import StepPlan
    from gmix_tpu_torch.utils.contexts_inputs import to_state

    S = len(sample["stm"]["acc"])
    plan = StepPlan(meta, S, dev)
    streams = sorted({0, S // 2, S - 1})
    cpu_plan = StepPlan(meta, len(streams), "cpu")
    t_dev = torch.full((), t, dtype=torch.int64, device=dev)
    NM = len(meta.spec.matches)

    def run(kernel, plain, launches):
        """`kernel(stm, ltm, plan, t)` and `plain(...)` update the state and
        return its other outputs by name; `launches`: (boundary, match)."""
        stm, ltm = to_state(meta, sample, dev)
        ptrs = {k: v.data_ptr() for k, v in {**stm, **ltm}.items()}
        n0 = (_launches("contexts_boundary"), _launches("match_pointer"))
        got = kernel(stm, ltm, plan, t_dev)
        torch.cuda.synchronize()
        assert (_launches("contexts_boundary") - n0[0], _launches("match_pointer") - n0[1]) == launches
        assert {k: v.data_ptr() for k, v in {**stm, **ltm}.items()} == ptrs
        got.update(stm, **ltm)
        p_stm, p_ltm = to_state(meta, sample, dev)
        want = plain(p_stm, p_ltm, plan, t_dev)
        _assert_leaves_equal(got, {**want, **p_stm, **p_ltm}, "card")
        del p_stm, p_ltm
        c_stm, c_ltm = to_state(meta, sample, "cpu", streams)
        want = plain(c_stm, c_ltm, cpu_plan, t_dev.cpu())
        _assert_leaves_equal(got, {**want, **c_stm, **c_ltm}, "cpu", streams)

    run(lambda stm, ltm, pl, at: contexts.boundary_contexts(stm, at, pl) or {},
        lambda stm, ltm, pl, at: contexts.boundary_plain(stm, at, pl) or {}, (1, 0))
    if NM:
        run(lambda stm, ltm, pl, at: {"match_ix": contexts.match_pointers(stm, ltm, pl)},
            lambda stm, ltm, pl, at: {"match_ix": contexts.match_plain(stm, ltm, pl)}, (0, 1))
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("streams", ["one", "cell"])
@pytest.mark.parametrize("name", list(CONTEXT_CELLS))
def test_contexts_kernels_match_plain(cuda, name, streams, t):
    """States as the codec leaves them (bytes in the byte leaves, u32
    hashes, short and long matches, empty histories), at one stream and at
    the benchmark cell's, at a stream's first byte and after it."""
    from gmix_tpu_torch.utils.contexts_inputs import random_state

    meta = _contexts_meta(name)
    S = 1 if streams == "one" else CONTEXT_CELLS[name]
    _check_contexts_kernels(meta, random_state(meta, S, 31 * S + t), cuda, t)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("name", list(CONTEXT_CELLS))
def test_contexts_kernels_at_the_edges(cuda, name, t):
    """One stream per corner (`utils/contexts_inputs.py` `edge_state`): an
    indirect-hash context whose new index is its old one, match lengths at
    255, the pointer at the history's end, an empty history, a pointer that
    wraps, a negative rolling-hash difference, bytes 0 and 255."""
    from gmix_tpu_torch.utils.contexts_inputs import edge_state

    meta = _contexts_meta(name)
    _check_contexts_kernels(meta, edge_state(meta, 3 + t), cuda, t)


@pytest.mark.cuda
def test_contexts_wrappers_reject_what_the_kernels_do_not_take(cuda):
    import gmix_tpu_torch as gt
    from gmix_tpu_torch.core import contexts
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.core.step import StepPlan
    from gmix_tpu_torch.utils.contexts_inputs import random_state, to_state

    meta = build_meta(gt.tiny_spec(True))
    plan = StepPlan(meta, 2, cuda)
    stm, ltm = to_state(meta, random_state(meta, 2, 1), cuda)
    t = torch.ones((), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="ctx is"):
        contexts.boundary_kernel({**stm, "ctx": stm["ctx"].to(torch.int32)}, t, plan)
    with pytest.raises(ValueError, match="recent is"):
        contexts.boundary_kernel({**stm, "recent": stm["recent"].T.contiguous().T}, t, plan)
    with pytest.raises(ValueError, match="t is"):
        contexts.boundary_kernel(stm, t.cpu(), plan)
    with pytest.raises(ValueError, match="match_len is"):
        contexts.match_kernel({**stm, "match_len": stm["match_len"].to(torch.int64)}, ltm, plan)
    with pytest.raises(ValueError, match="hist is"):
        contexts.match_kernel(stm, {**ltm, "hist": ltm["hist"][:, :8].contiguous()}, plan)


# ---------------------------------------------------------------------------
# the LSTM kernels (csrc/lstm.cu): the forward pass and the output layer's SGD
# ---------------------------------------------------------------------------

# the benchmark's configurations at their cells' stream counts, one stream,
# and the tiny spec's LSTM (16 cells, horizon 10)
LSTM_CASES = {"gmix-ref-x54": ("ref", 54), "gmix-best-x30": ("best", 30), "gmix-ref-x1": ("ref", 1),
              "tiny-lstm": ("tiny", 3)}


def _lstm_meta(name):
    import gmix_tpu_torch as gt
    from gmix_tpu_torch.core.meta import build_meta

    return build_meta({"ref": gt.reference_spec, "best": gt.best_spec, "tiny": lambda: gt.tiny_spec(True)}[name]())


def _check_lstm_kernels(meta, sample, dev, cluster=None):
    """The forward kernel, then the perceive kernel on what it left, against
    the plain versions on the card, every stream, and on the CPU, three
    streams, bit for bit: every leaf the two read or write, the head's
    registers, the `lstm_ctx` context; one launch each, counted, and every
    leaf written in place. The byte that wraps the window (the epoch leaf
    back at 0) records its symbol op by op and launches the SGD alone."""
    from gmix_tpu_torch.core import lstm
    from gmix_tpu_torch.utils.lstm_inputs import to_state

    ls = meta.spec.lstm
    slot = int(meta.slots["lstm_ctx"])
    S = len(sample["stm"]["acc"])
    streams = sorted({0, S // 2, S - 1})
    wrap = int(sample["stm"]["lstm"]["epoch"]) == ls.horizon - 1

    def step(stm, ltm, lp, kernel):
        if kernel:
            regs = lstm.lstm_forward_kernel(stm, ltm, lp, slot, cluster) if cluster else lstm._lstm_forward(
                stm, ltm, lp, slot)
        else:
            regs = lstm.lstm_forward_plain(stm, ltm, lp, slot)
        after = {"regs": regs, **{f"fwd.{k}": v.clone() for k, v in {**stm["lstm"], **ltm["lstm"]}.items()}}
        if kernel:
            lstm._lstm_perceive(stm, ltm, stm["acc"], lp, wrap, bptt=False)
        else:
            lstm.lstm_perceive_plain(stm, ltm, stm["acc"], lp, wrap, bptt=False)
        return {**after, "ctx": stm["ctx"], **stm["lstm"], **{f"ltm.{k}": v for k, v in ltm["lstm"].items()}}

    stm, ltm = to_state(sample, dev)
    ptrs = {k: v.data_ptr() for k, v in {**stm["lstm"], **ltm["lstm"]}.items() if k != "old_input"}
    n0 = (_launches("lstm_forward"), _launches("lstm_perceive"))
    got = step(stm, ltm, lstm.LstmPlan(ls, S, dev), True)
    torch.cuda.synchronize()
    if cluster is None:
        assert (_launches("lstm_forward") - n0[0], _launches("lstm_perceive") - n0[1]) == (1, 1)
    assert {k: v.data_ptr() for k, v in {**stm["lstm"], **ltm["lstm"]}.items() if k != "old_input"} == ptrs
    assert int(stm["lstm"]["epoch"]) == (int(sample["stm"]["lstm"]["epoch"]) + 1) % ls.horizon
    p_stm, p_ltm = to_state(sample, dev)
    _assert_leaves_equal(got, step(p_stm, p_ltm, lstm.LstmPlan(ls, S, dev), False), "card")
    del p_stm, p_ltm
    c_stm, c_ltm = to_state(sample, "cpu", streams)
    want = step(c_stm, c_ltm, lstm.LstmPlan(ls, len(streams), "cpu"), False)
    for k, w in want.items():
        g = got[k] if got[k].dim() == 0 else got[k][streams]
        assert _bits_equal(g, w), f"{k} differs from the plain version on the cpu"
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("epoch", ["mid", "last"])
@pytest.mark.parametrize("name", list(LSTM_CASES))
def test_lstm_kernels_match_plain(cuda, name, epoch):
    """Seeded states of the size a running model holds, at the benchmark's
    stream counts, one stream and the tiny spec; mid-window and at the last
    epoch, whose byte wraps the window."""
    from gmix_tpu_torch.utils.lstm_inputs import random_state

    meta = _lstm_meta(LSTM_CASES[name][0])
    S, Hz = LSTM_CASES[name][1], meta.spec.lstm.horizon
    e = Hz // 2 if epoch == "mid" else Hz - 1
    _check_lstm_kernels(meta, random_state(meta, S, 7 * S + e, e), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("epoch", ["first", "last"])
@pytest.mark.parametrize("name", ["ref", "best", "tiny"])
def test_lstm_kernels_at_the_edges(cuda, name, epoch):
    """One stream per corner (`utils/lstm_inputs.py` `edge_state`): two
    equal largest logits, every logit negative, pre-activations past +-87,
    -0.0 products in a padded tree, bytes 0 and 255; at epoch 0 and at the
    last epoch."""
    from gmix_tpu_torch.utils.lstm_inputs import edge_state

    meta = _lstm_meta(name)
    e = 0 if epoch == "first" else meta.spec.lstm.horizon - 1
    _check_lstm_kernels(meta, edge_state(meta, 5, e), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cluster", [("ref", 2), ("ref", 4), ("ref", 8), ("tiny", 1), ("tiny", 2)])
def test_lstm_forward_kernel_gives_the_same_bits_at_every_cluster_size(cuda, name, cluster):
    """The blocks a stream change which block computes what, not one bit
    (at 50 cells one block a stream does not fit its shared memory)."""
    from gmix_tpu_torch.utils.lstm_inputs import random_state

    meta = _lstm_meta(name)
    _check_lstm_kernels(meta, random_state(meta, 5, 41, 3), cuda, cluster)


@pytest.mark.cuda
def test_lstm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from gmix_tpu_torch.core import lstm
    from gmix_tpu_torch.utils.lstm_inputs import random_state, to_state

    meta = _lstm_meta("tiny")
    ls, slot = meta.spec.lstm, int(meta.slots["lstm_ctx"])
    lp = lstm.LstmPlan(ls, 2, cuda)
    stm, ltm = to_state(random_state(meta, 2, 1, 3), cuda)
    with pytest.raises(ValueError, match="cell is"):
        lstm.lstm_forward_kernel({**stm, "lstm": {**stm["lstm"], "cell": stm["lstm"]["cell"].double()}}, ltm, lp, slot)
    with pytest.raises(ValueError, match="w_in is"):
        lstm.lstm_forward_kernel(stm, {"lstm": {**ltm["lstm"], "w_in": ltm["lstm"]["w_in"].transpose(1, 2)}}, lp,
                                 slot)
    with pytest.raises(ValueError, match="inp is"):
        lstm.lstm_perceive_kernel(stm, ltm, stm["acc"].to(torch.int32), lp, True)
    with pytest.raises(ValueError, match="out_w is"):
        lstm.lstm_perceive_kernel(stm, {"lstm": {**ltm["lstm"], "out_w": ltm["lstm"]["out_w"][:, :, 1:]}}, stm["acc"],
                                  lp, True)
    with pytest.raises(ValueError, match="up to 63 cells"):
        lstm.lstm_forward_kernel(stm, ltm, lstm.LstmPlan(dataclasses.replace(ls, num_cells=64), 2, cuda), slot)
    with pytest.raises(RuntimeError, match="lstm_forward: CUDA error"):
        lstm.lstm_forward_kernel(stm, ltm, lp, slot, cluster=3)
    ref = _lstm_meta("ref")
    r_stm, r_ltm = to_state(random_state(ref, 1, 2, 3), cuda)
    with pytest.raises(RuntimeError, match="lstm_forward: CUDA error"):  # 236 KB of shared memory
        lstm.lstm_forward_kernel(r_stm, r_ltm, lstm.LstmPlan(ref.spec.lstm, 1, cuda), int(ref.slots["lstm_ctx"]),
                                 cluster=1)


# ---------------------------------------------------------------------------
# the inputs kernel (csrc/inputs.cu): row indices, dense rows, packing
# ---------------------------------------------------------------------------

# the benchmark's configurations at their cells' stream counts, one stream of
# ref, the grouped-PPM profile, and variants with empty classes
INPUTS_CASES = {"gmix-ref-x54": ("gmix-ref", 54), "gmix-best-x30": ("gmix-best", 30),
                "ref-noppm-x63": ("ref-noppm", 63), "gmix-ref-x1": ("gmix-ref", 1), "ref-ppm-x4": ("ref-ppm", 4),
                "ablate-indonly-x3": ("ref:ablate-indonly", 3), "ablate-mixtb0-x3": ("ref:ablate-mixtb0", 3)}


def _inputs_meta(name):
    import gmix_tpu_torch as gt
    from gmix_tpu_torch import bench
    from gmix_tpu_torch.core.meta import build_meta

    makers = {"gmix-ref": gt.reference_spec, "gmix-best": gt.best_spec, "ref-noppm": bench.ref_noppm_spec,
              "ref-ppm": bench.ref_ppm_spec}
    return build_meta(makers[name]() if name in makers else bench.parse_profile(name)[1])


def _check_inputs_kernel(meta, sample, dev):
    """The kernel on `sample` against the plain version on the card, every
    stream, and on the CPU, on three streams' rows, bit for bit: every output
    of `out_layout`; one launch, counted; no input written."""
    from gmix_tpu_torch.core import inputs
    from gmix_tpu_torch.core.step import StepPlan
    from gmix_tpu_torch.utils.inputs_inputs import to_state

    S = len(sample["stm"]["acc"])
    streams = sorted({0, S // 2, S - 1})
    state, args = to_state(sample, dev)
    before = {k: v.clone() for k, v in {**state["stm"], **state["coder"], **state["ltm"]}.items()}
    n0 = _launches("inputs_pack")
    got = inputs.byte_inputs(state, plan=StepPlan(meta, S, dev), **args)
    torch.cuda.synchronize()
    assert _launches("inputs_pack") - n0 == 1
    for k, v in {**state["stm"], **state["coder"], **state["ltm"]}.items():
        assert _bits_equal(v, before[k]), f"the kernel wrote {k}"
    layout = inputs.out_layout(meta, args["sample_u"] is not None)
    assert [(k, tuple(got[k].shape), got[k].dtype) for k, _, _ in layout] == [(k, (S,) + t, d) for k, t, d in layout]
    want = inputs.inputs_plain(state, plan=StepPlan(meta, S, dev), **args)
    assert sorted(want) == sorted(got)
    for k in want:
        assert _bits_equal(got[k], want[k]), f"{k} differs from the plain version on the card"
    c_state, c_args = to_state(sample, "cpu", streams)
    want = inputs.inputs_plain(c_state, plan=StepPlan(meta, len(streams), "cpu"), **c_args)
    for k in want:
        assert _bits_equal(got[k][streams], want[k]), f"{k} differs from the plain version on the cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["encode", "decode", "decode-past-end", "sample"])
@pytest.mark.parametrize("name", list(INPUTS_CASES))
def test_inputs_kernel_matches_plain(cuda, name, mode):
    """Seeded steps as the codec runs them (u32 contexts, -0.0 and
    denormals in one-row and wider ctx-dense tables, contexts at 2^32 - 1),
    encode and decode, the decoder's window past its code stream's end, a
    sampling step; at the benchmark's cells, one stream, the grouped-PPM
    profile and variants with empty classes."""
    from gmix_tpu_torch.utils.inputs_inputs import random_sample

    spec_name, S = INPUTS_CASES[name]
    meta = _inputs_meta(spec_name)
    _check_inputs_kernel(meta, random_sample(meta, S, 17 * S + len(mode), mode, t=5 * (mode in ("decode", "sample"))), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gmix-ref", "ref:ablate-mixtb0"])
def test_inputs_kernel_flushes_as_the_plain_version(cuda, name):
    """Each stream's dense arena -0.0, +0.0, a denormal or FLT_MIN of either
    sign (`edge_sample`): a T > 1 ctx-dense row reads +0.0 where the plain
    version does, a one-row table keeps every bit, the copies keep every
    bit."""
    from gmix_tpu_torch.utils.inputs_inputs import edge_sample

    _check_inputs_kernel(_inputs_meta(name), edge_sample(_inputs_meta(name), 5), cuda)


@pytest.mark.cuda
def test_inputs_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from gmix_tpu_torch.core import inputs
    from gmix_tpu_torch.core.step import StepPlan
    from gmix_tpu_torch.utils.inputs_inputs import random_sample, to_state

    meta = _inputs_meta("gmix-ref")
    plan = StepPlan(meta, 2, cuda)
    state, args = to_state(random_sample(meta, 2, 1, "decode"), cuda)
    stm = state["stm"]
    with pytest.raises(ValueError, match="ctx is"):
        inputs.inputs_kernel({**state, "stm": {**stm, "ctx": stm["ctx"].to(torch.int32)}}, plan=plan, **args)
    with pytest.raises(ValueError, match="data is"):
        inputs.inputs_kernel(state, plan=plan, **{**args, "data_buf": args["data_buf"].to(torch.int64)})
    with pytest.raises(ValueError, match="code is"):
        inputs.inputs_kernel(state, plan=plan, **{**args, "code_buf": args["code_buf"].T.contiguous().T})
    with pytest.raises(ValueError, match="col is"):
        inputs.inputs_kernel(state, plan=plan, **{**args, "col": args["col"].cpu()})
    with pytest.raises(ValueError, match="dense is"):
        inputs.inputs_kernel({**state, "ltm": {"mix_dense": state["ltm"]["mix_dense"][:, 1:]}}, plan=plan, **args)
