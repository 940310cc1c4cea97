"""The port's hand-written CUDA kernels: one row each, and the one checked
path by which the package calls them.

`KERNELS` has a row for every kernel of csrc/ that the byte step launches:
its name as a device trace shows it (the `__global__` function), the C
entry that launches it and the entry's argument types, the entry that
readies it on a device before a CUDA graph capture records a launch, its
source, the wrappers under whose names its launches are counted
(`obs.launched`), and how many times a byte step of a spec launches it.
The rows are in the order of every tuple of launch counts the package and
chip_smoke.py print. The build's declarations (`load_kernels`), the
graphs' capture (`prepare`), the bench, chip_smoke.py and the tests read
the table. Adding a kernel: its .cu file under csrc/, its wrapper, and one
row.

`launch` is the call a struct-argument wrapper makes: it checks every
tensor (one CUDA device, dtype, shape, contiguity and, where asked, 16-byte
alignment), fills the kernel's argument structure, calls its entry on the
device's current stream, raises on a CUDA error and counts the launch. The
movers and the fused kernel pack their own arguments and use `check` and
`call`. A wrapper refuses CPU tensors with one message for every kernel:
on the CPU the plain version beside it runs.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .. import obs
from ..utils.build import build

P, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
NOT_CUDA = "the kernel takes CUDA tensors (its plain version runs on the CPU)"


def _struct(c_name: str, ptrs: str, ints: str, floats: str = "") -> type:
    """A ctypes declaration of the C structure `c_name`: pointers, then
    int64 fields, then floats, in that order."""
    fields = [(n, P) for n in ptrs.split()] + [(n, I64) for n in ints.split()] + [(n, F32) for n in floats.split()]
    return type(c_name, (ctypes.Structure,), {"_fields_": fields})


GmixPpmArgs = _struct("GmixPpmArgs", "raw cv completed see rows_out see_out probs top bot",
                      "S NO NB inc rescale_total exclusion update_exclusion", "see_lr")
GmixContextsArgs = _struct("GmixContextsArgs", "t acc last_byte recent ctx roll_h ih_tbl ih_outer_ctx ih_outer_hash "
                           "consts", "S R n_ctx NI NSK NR NIH ih_total")
GmixMatchArgs = _struct("GmixMatchArgs", "new_bit hist_n ctx match_ptr match_byte match_len match_tbl hist match_ix "
                        "consts", "S NM n_ctx match_total history_size")
GmixLstmForwardArgs = _struct("GmixLstmForwardArgs", "epoch aux sym w_sym w_in gamma beta out_w mid cell hidden probs "
                              "top bot regs layer_input norm ivar gate_state tanh_state in_gate last_state outputs ctx "
                              "done", "S C Hz IN OUT n_ctx ctx_slot cluster")
GmixInputsArgs = _struct("GmixInputsArgs", "t col ctx dense data code last_byte recent acc bits_seen new_bit x1 x2 x wpos "
                         "rpos ppm_top ppm_bot ppm_mid sample_u consts blk_ix rowix_st posix apm_ix ppm_ix ppm_cv "
                         "ind_rot rows_cd cd_oh blocks_pd lm_tbl sc coder win_r ppm_regs sample_out",
                         "S n_ctx D WP R n_data cap M Kst Kp NA NO Kcd Tcd NPD NLM decode sample regs")
GmixLstmPerceiveArgs = _struct("GmixLstmPerceiveArgs", "epoch inp outputs hidden out_w in_hist",
                               "S C Hz OUT record inp_stride", "lr")


@dataclass(frozen=True)
class Kernel:
    name: str  # the __global__ function, as a device trace names it
    entry: str  # the C function that launches it: (argtypes..., stream) -> CUDA error
    argtypes: tuple
    prepare: Optional[str]  # () -> CUDA error: loads it on the current device (None: core/fused.py's plan does)
    source: str  # under csrc/
    wrappers: Tuple[str, ...]  # the names its launches are counted under
    per_step: Callable  # (spec, sampling) -> its launches in one byte step
    struct: Optional[type] = None  # the structure its entry takes a pointer to


def _ppm(spec) -> int:
    return int(spec.ppm is not None)


def _lstm(spec) -> int:
    return int(spec.lstm is not None)


# A byte step gathers the movers' arenas in one launch and scatters them in
# one at its end (none in a sampling step); with PPM its count update moves
# its own `ppm_tbl` rows first, and with PPM and the LSTM the prediction's
# rows are gathered alone before the forward pass (core/step.py). A
# sampling step has no output-layer SGD. Every step packs its inputs, the
# grouped gather's indices among them, in one launch before that gather.
KERNELS = (
    Kernel("gather_rows_many_kernel", "gmix_gather_rows_many", (P, I32), "gmix_rowmove_prepare", "rowmove.cu",
           ("gather_rows", "gather_rows_many"), lambda spec, sampling: 1 + _ppm(spec) + _ppm(spec) * _lstm(spec)),
    Kernel("scatter_rows_many_kernel", "gmix_scatter_rows_many", (P, I32), "gmix_rowmove_prepare", "rowmove.cu",
           ("scatter_rows", "scatter_rows_many"), lambda spec, sampling: int(not sampling) + _ppm(spec)),
    Kernel("fused_substeps_kernel", "gmix_fused_substeps", (P, P), None, "fused.cu", ("fused_substeps",),
           lambda spec, sampling: 1),
    Kernel("ppm_update_kernel", "gmix_ppm_update", (P,), "gmix_ppm_prepare", "ppm.cu", ("ppm_update",),
           lambda spec, sampling: _ppm(spec), GmixPpmArgs),
    Kernel("ppm_predict_kernel", "gmix_ppm_predict", (P,), "gmix_ppm_prepare", "ppm.cu", ("ppm_predict",),
           lambda spec, sampling: _ppm(spec), GmixPpmArgs),
    Kernel("contexts_boundary_kernel", "gmix_contexts_boundary", (P,), "gmix_contexts_prepare", "contexts.cu",
           ("contexts_boundary",), lambda spec, sampling: 1, GmixContextsArgs),
    Kernel("match_pointer_kernel", "gmix_match_pointer", (P,), "gmix_contexts_prepare", "contexts.cu",
           ("match_pointer",), lambda spec, sampling: int(bool(spec.matches)), GmixMatchArgs),
    Kernel("lstm_forward_kernel", "gmix_lstm_forward", (P,), "gmix_lstm_prepare", "lstm.cu", ("lstm_forward",),
           lambda spec, sampling: _lstm(spec), GmixLstmForwardArgs),
    Kernel("lstm_perceive_kernel", "gmix_lstm_perceive", (P,), "gmix_lstm_prepare", "lstm.cu", ("lstm_perceive",),
           lambda spec, sampling: _lstm(spec) * int(not sampling), GmixLstmPerceiveArgs),
    Kernel("inputs_pack_kernel", "gmix_inputs_pack", (P,), "gmix_inputs_prepare", "inputs.cu", ("inputs_pack",),
           lambda spec, sampling: 1, GmixInputsArgs),
)
BY_WRAPPER = {w: k for k in KERNELS for w in k.wrappers}

# the library's entries that launch no kernel of the byte step:
# (argument types, result type)
OTHER_ENTRIES = {
    "gmix_empty_launch": ((P,), I32),  # rowmove.cu's empty kernel on a stream
    "gmix_fused_substeps_clocks": ((P, P, P), I32),  # the fused kernel's clocks instantiation
    "gmix_fused_substeps_plan": ((P, P), I32),  # (dims, int64[3] out): the instantiation a launch takes
    "gmix_fused_substeps_prepare": ((P,), I32),  # (dims): its shared-memory opt-in on the current device
    "gmix_cuda_error_string": ((I32,), ctypes.c_char_p),
}


def launches_per_step(spec, sampling: bool = False) -> Tuple[int, ...]:
    """Each kernel's launches (in `KERNELS`' order) in one encode or decode
    byte step of `spec`, or with `sampling` one sampling step."""
    return tuple(k.per_step(spec, sampling) for k in KERNELS)


def launch_counts(by_wrapper: Mapping[str, int]) -> Tuple[int, ...]:
    """Launch counts by wrapper (`obs.launches()`, a graph's record) as
    counts by kernel, in `KERNELS`' order."""
    return tuple(sum(by_wrapper.get(w, 0) for w in k.wrappers) for k in KERNELS)


_lib: Optional[ctypes.CDLL] = None


def load_kernels() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        entries = dict(OTHER_ENTRIES)
        for k in KERNELS:
            entries[k.entry] = ((*k.argtypes, P), I32)
            if k.prepare is not None:
                entries[k.prepare] = ((), I32)
        for name, (argtypes, restype) in entries.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
        _lib = lib
    return _lib


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = load_kernels().gmix_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def cuda_device(what: str, name: str, t: torch.Tensor) -> torch.device:
    """`t`'s device, which must be a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} is on {t.device}; {NOT_CUDA}")
    return t.device


def check(what: str, tensors: Mapping[str, Tuple[torch.Tensor, tuple, torch.dtype]], aligned=(), strided=(),
          dev: Optional[torch.device] = None) -> torch.device:
    """The one CUDA device of `tensors` (name: (tensor, shape, dtype)): the
    first one's, or `dev`. Each is checked for it, its dtype and shape,
    contiguity (but the names in `strided`, whose stride the kernel takes)
    and, for the names in `aligned`, 16-byte alignment."""
    if dev is None:
        name, (first, _, _) = next(iter(tensors.items()))
        dev = cuda_device(what, name, first)
    for name, (t, shape, dtype) in tensors.items():
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not (name in strided or t.is_contiguous())):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} on {t.device} (contiguous: "
                             f"{t.is_contiguous()}), expected {tuple(shape)} {dtype} on {dev}"
                             + ("" if name in strided else ", contiguous"))
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return dev


def _on_device(entry: str, dev: torch.device, args, what: str, stream: bool) -> None:
    lib = load_kernels()
    with torch.cuda.device(dev):
        extra = (torch.cuda.current_stream(dev).cuda_stream,) if stream else ()
        rc = getattr(lib, entry)(*args, *extra)
    check_launch(rc, what)


def call(wrapper: str, dev: torch.device, *args) -> None:
    """One launch of the kernel that `wrapper` counts: its entry called with
    `args` on `dev`'s current stream, raising on a CUDA error; counted under
    `wrapper`, which must be a wrapper of the table."""
    if wrapper not in BY_WRAPPER:
        raise ValueError(f"{wrapper} is not a wrapper of a kernel of the table")
    _on_device(BY_WRAPPER[wrapper].entry, dev, args, wrapper, stream=True)
    obs.launched(wrapper)


def launch(wrapper: str, args: Mapping, tensors: Dict[str, Tuple[torch.Tensor, tuple, torch.dtype]], aligned=(),
           strided=()) -> None:
    """One launch of the kernel that `wrapper` counts on CUDA tensors: its
    argument structure holds the scalars `args` and the pointers of
    `tensors` (name: (tensor, shape, dtype)), checked first (`check`)."""
    dev = check(wrapper, tensors, aligned, strided)
    st = BY_WRAPPER[wrapper].struct(**args, **{name: t.data_ptr() for name, (t, _, _) in tensors.items()})
    call(wrapper, dev, ctypes.byref(st))


def prepare(device) -> None:
    """Load every kernel of the table on `device` (a CUDA device), as its
    first launch would, before a CUDA graph capture records a launch. The
    fused kernel is readied with its launch plan (core/fused.py)."""
    dev = torch.device(device)
    for entry in dict.fromkeys(k.prepare for k in KERNELS if k.prepare):
        _on_device(entry, dev, (), entry, stream=False)


def fused_plan(dims) -> Tuple[int, int, int]:
    """The fused kernel's instantiation for the sizes `dims` (a reference to
    core/fused.py's FusedDims): lane groups, tables in shared memory, shared
    bytes."""
    out = (ctypes.c_int64 * 3)()
    check_launch(load_kernels().gmix_fused_substeps_plan(dims, out), "fused_substeps")
    return int(out[0]), int(out[1]), int(out[2])


def fused_prepare(dev: torch.device, dims) -> None:
    """The fused kernel's shared-memory opt-in for `dims` on `dev`."""
    _on_device("gmix_fused_substeps_prepare", dev, (dims,), "fused_substeps", stream=False)


def fused_clocks(dev: torch.device, dims, io) -> None:
    """One launch of the fused kernel's clocks instantiation, for
    measurement: not counted as a launch of the byte step's kernel."""
    _on_device("gmix_fused_substeps_clocks", dev, (dims, io), "fused_substeps", stream=True)


def empty_launch(device) -> None:
    """rowmove.cu's empty kernel on `device`'s current stream: the
    device-side cost of a launch, for measurement beside the movers'."""
    _on_device("gmix_empty_launch", torch.device(device), (), "empty_launch", stream=True)
