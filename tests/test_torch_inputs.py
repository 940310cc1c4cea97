"""The byte step's inputs part (gmix_tpu_torch/core/inputs.py) on the CPU:
the kernel's constant table against the spec's `Meta`, and csrc/inputs.cu's
walk over that table, task by task in numpy, against the plain version.

The kernel itself runs on a card only (tests/test_torch_kernels.py); the
plain version is held against gmix_tpu by tests/test_torch_step.py. Imports
torch and gmix_tpu_torch only."""
import dataclasses

import numpy as np
import pytest
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch import bench
from gmix_tpu_torch.core import inputs
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.core.step import StepPlan
from gmix_tpu_torch.utils import inputs_inputs

# the benchmark's three configurations, the grouped-PPM profile, and variants
# with empty classes (no position, pos-dense or longest-match mixers, no
# match models; no stable or position mixers, one-row ctx-dense tables)
SPECS = {"gmix-ref": gt.reference_spec, "gmix-best": gt.best_spec, "ref-noppm": bench.ref_noppm_spec,
         "ref-ppm": bench.ref_ppm_spec, "ref:ablate-indonly": lambda: bench.parse_profile("ref:ablate-indonly")[1],
         "ref:ablate-mixtb0": lambda: bench.parse_profile("ref:ablate-mixtb0")[1],
         "tiny-lstm": lambda: gt.tiny_spec(True)}


def _meta(name):
    return build_meta(SPECS[name]())


def _split(meta, table):
    """The table cut into its parts, as csrc/inputs.cu reads it."""
    d = inputs._sizes(meta)
    nix = d["M"] + d["Kst"] + d["Kp"] + d["NA"] + d["NO"]
    ix = table[: 3 * nix].reshape(nix, 3)
    rot = table[3 * nix : 3 * nix + d["M"]]
    at = 3 * nix + d["M"]
    dense = table[at : at + 4 * d["Kcd"]].reshape(d["Kcd"], 4)
    copies = table[at + 4 * d["Kcd"] :]
    return ix, rot, dense, copies


@pytest.mark.parametrize("name", list(SPECS))
def test_inputs_table_holds_the_spec(name):
    """Every index's (slot, mask, offset) class by class, the rotation
    flags, each ctx-dense table's (slot, rows, arena row, mask lane) and the
    arena row of each pos-dense and longest-match row, from `Meta`'s fields;
    the PPM orders only where their rows join the grouped gather."""
    meta = _meta(name)
    spec = meta.spec
    table = inputs.inputs_table(meta)
    assert table.dtype == np.int64
    ix, rot, dense, copies = _split(meta, table)
    classes = [(meta.ind_ctx_slots, meta.ind_blk_masks, meta.ind_blk_offsets),
               (meta.mix_st_slots, meta.mix_st_masks, meta.mix_st_offsets),
               (meta.mix_pos_slots, meta.mix_pos_masks, meta.mix_pos_offsets),
               (meta.apm_ctx_slots, meta.apm_masks, meta.apm_offsets)]
    assert inputs.ppm_grouped(spec) == (spec.ppm is not None and spec.lstm is None)
    if inputs.ppm_grouped(spec):
        classes.append((meta.ppm_slots, meta.ppm_masks, meta.ppm_row_offsets))
    want = np.concatenate([np.stack([np.asarray(a, np.int64).reshape(-1) for a in c], axis=1) for c in classes])
    np.testing.assert_array_equal(ix, want)
    np.testing.assert_array_equal(rot, np.asarray(meta.ind_rotate, np.int64))
    sizes = np.asarray(meta.mix_cd_sizes, np.int64)
    np.testing.assert_array_equal(dense[:, 0], meta.mix_cd_slots)
    np.testing.assert_array_equal(dense[:, 1], sizes)
    np.testing.assert_array_equal(dense[:, 2], meta.mix_cd_offsets)
    np.testing.assert_array_equal(dense[:, 3], np.concatenate([[0], np.cumsum(sizes)[:-1]])[: len(sizes)])
    rows = [o + np.arange(8) for o in meta.mix_pd_offsets]
    rows += [o + np.arange(T) for o, T in zip(meta.mix_lm_offsets, meta.mix_lm_sizes)]
    np.testing.assert_array_equal(copies, np.concatenate(rows) if rows else np.zeros(0, np.int64))
    assert copies.size == 0 or copies.max() < meta.mix_dense_total


def test_inputs_table_refuses_a_table_the_select_cannot_mask():
    meta = _meta("gmix-ref")
    bad = meta.mix_cd_sizes.copy()
    bad[0] = 12
    with pytest.raises(ValueError, match="powers of two"):
        inputs.inputs_table(dataclasses.replace(meta, mix_cd_sizes=bad))


def _walk(meta, table, state, args):
    """csrc/inputs.cu's `inputs_pack_kernel` in numpy, one task at a time:
    the outputs of `out_layout` by name."""
    d = inputs._sizes(meta)
    S = len(state["stm"]["acc"])
    stm, coder = {k: v.numpy() for k, v in state["stm"].items()}, {k: v.numpy() for k, v in state["coder"].items()}
    dense = state["ltm"]["mix_dense"].numpy().view(np.uint32) if "mix_dense" in state["ltm"] else None
    out = {name: np.zeros((S,) + tail, torch.empty(0, dtype=dtype).numpy().dtype)
           for name, tail, dtype in inputs.out_layout(meta, args["sample_u"] is not None)}
    ix, rot, dense_tab, copies = _split(meta, table)
    names = [("blk_ix", d["M"]), ("rowix_st", d["Kst"]), ("posix", d["Kp"]), ("apm_ix", d["NA"]), ("ppm_ix", d["NO"])]
    t, col, decode = int(args["t"]), int(args["col"]), args["decode"]
    data, code = args["data_buf"].numpy(), args["code_buf"].numpy()
    for s in range(S):
        ctx = stm["ctx"][s]
        j = 0
        for name, n in names:
            for i in range(n):
                slot, mask, off = ix[j]
                out[name][s, i] = np.int32(np.int64((ctx[slot] & mask) + off).astype(np.int32))
                if name == "blk_ix":
                    out["ind_rot"][s, i] = ((ctx[slot] >> 16) & 255) * rot[i]
                if name == "ppm_ix":
                    out["ppm_cv"][s, i] = ctx[slot]
                j += 1
        srcs = []
        for r, (slot, T, doff, ohoff) in enumerate(dense_tab):
            val = ctx[slot] & (T - 1)
            out["cd_oh"][s, ohoff : ohoff + T] = np.arange(T) == val
            srcs.append((doff + val, T > 1))
        srcs += [(r, False) for r in copies]
        rows = []
        for src, flush in srcs:
            w = dense[s, src].copy()
            if flush:
                w[(w & 0x7FFFFFFF) < 0x00800000] = 0
            rows.append(w.view(np.float32))
        at = 0
        for name, n in (("rows_cd", d["Kcd"]), ("blocks_pd", d["NPD"]), ("lm_tbl", d["NLM"])):
            if n:
                out[name][s] = np.stack(rows[at : at + n])
            at += n
        out["sc"][s] = [data[s, col], stm["last_byte"][s], stm["recent"][s, 1], int(decode), int(t > 0),
                        int(args["sample_u"] is not None), 0, 0]
        out["coder"][s] = [coder["x1"][s], coder["x2"][s], coder["x"][s], coder["wpos"][s], coder["rpos"][s],
                           stm["acc"][s], stm["bits_seen"][s], stm["new_bit"][s]]
        for w in range(40 if decode else 0):
            look = coder["rpos"][s] + w
            out["win_r"][s, w] = code[s, look] if look < code.shape[1] else 0
        if d["regs"]:
            out["ppm_regs"][s] = [stm["ppm_top"][s], stm["ppm_bot"][s], stm["ppm_mid"][s], 0]
        if args["sample_u"] is not None:
            out["sample_u"][s] = args["sample_u"].numpy()[:, s]
    return out


@pytest.mark.parametrize("mode", list(inputs_inputs.MODES))
@pytest.mark.parametrize("name", ["gmix-ref", "ref-noppm", "ref-ppm", "ref:ablate-indonly", "ref:ablate-mixtb0"])
def test_table_walk_gives_the_plain_outputs(name, mode):
    """The kernel's algorithm over the table (`_walk`) gives the plain
    version's outputs bit for bit, and `out_layout`'s names, shapes and
    dtypes, on seeded samples: -0.0 and denormals in one-row and wider
    ctx-dense tables, contexts at 2^32 - 1, the decoder's window past its
    code stream's end, a sampling step."""
    meta = _meta(name)
    S = 3
    plan = StepPlan(meta, S, "cpu")
    state, args = inputs_inputs.to_state(inputs_inputs.random_sample(meta, S, 7, mode), "cpu")
    got = inputs.inputs_plain(state, plan=plan, **args)
    layout = inputs.out_layout(meta, mode == "sample")
    assert sorted(got) == sorted(k for k, _, _ in layout)
    for k, tail, dtype in layout:
        assert tuple(got[k].shape) == (S,) + tail and got[k].dtype == dtype, k
    want = _walk(meta, inputs.inputs_table(meta), state, args)
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy()
        assert np.array_equal(g.view(np.uint8), want[k].view(np.uint8)), k
    if mode == "decode-past-end":
        assert (args["code_buf"].shape[1] - state["coder"]["rpos"] < 40).all()


def test_plain_version_flushes_as_gmix_tpu_reads_a_dense_row():
    """A ctx-dense table of T > 1 rows reads +0.0 for -0.0 and for a
    denormal of either sign and keeps every other value; a table of one row
    keeps every bit (`_onehot_rows`, XLA's flush in a one-hot sum)."""
    meta = _meta("gmix-ref")
    plan = StepPlan(meta, 1, "cpu")
    sample = inputs_inputs.random_sample(meta, 1, 3)
    tiny = np.float32(np.finfo(np.float32).tiny)
    special = np.array([-0.0, 1e-40, -1e-40, tiny, -tiny, 2.5], np.float32)
    sample["dense"][0, :, : len(special)] = special
    state, args = inputs_inputs.to_state(sample, "cpu")
    got = inputs.inputs_plain(state, plan=plan, **args)["rows_cd"][0, :, : len(special)].numpy()
    wide = np.asarray(meta.mix_cd_sizes) > 1
    flushed = np.array([0.0, 0.0, 0.0, tiny, -tiny, 2.5], np.float32)
    assert np.array_equal(got[wide].view(np.uint32), np.broadcast_to(flushed, got[wide].shape).view(np.uint32))
    assert np.array_equal(got[~wide].view(np.uint32), np.broadcast_to(special, got[~wide].shape).view(np.uint32))
