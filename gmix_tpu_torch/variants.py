"""Ensemble variants: the spec constructors of the repository's three
ensemble-variant tools, as plain functions on the port's `EnsembleSpec`.

- `ladder(spec, v)`: tools/tpu_fast_ladder.py's `trim_spec`, trimmed
  ensembles for the throughput frontier (encode bytes/s against bpb).
- `ablate(spec, v)`: tools/tpu_ablate.py's `variant`, one component removed
  (the step's time split by part). The tool scales `reference_spec()` by
  `GMIX_ABLATE_BITS` first; here the variant applies to the spec it is
  given, so the tool's spec is `ablate(scale_tables(reference_spec(), bits,
  history_bits=min(24, bits + 4)), v)`.
- `quality(name)`: tools/tpu_quality.py's `make_variant`, the spec and the
  streams that a variant's name gives (encode-only bpb by variant).

The tools import gmix_tpu; the port keeps its own copy. Every function
validates the spec it returns, and an unknown name raises ValueError (the
fast ladder's tool returns an unknown name's spec unchanged, and quality's
reads any unknown family as `scaled-` and ignores an unknown suffix: here
they are refused).

Two names mean different specs in the two tools: `noih` drops only the
`ind_ih_*` models in the ladder, and also the indirect-hash contexts (with
their mixers re-gated on `last_byte`) in the ablation; `nolstm` drops the
models and mixers gated on `lstm_ctx` with the LSTM in the ladder, and keeps
them in the ablation.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Tuple

from .config import ApmStage, EnsembleSpec, PpmOrder, PpmSpec, best_spec, reference_spec, scale_tables

LADDER = ("base", "no4sel", "noskipind", "noih", "nolstm", "noskipind-noih", "lean")
ABLATE = ("full", "nolstm", "noppm", "nolstmppm", "nomatch", "noih", "nomix12", "mixtb0", "mixtb4", "mix6", "indonly")
# tools/tpu_fast_ladder.py:61-62, the four-byte-selector skip indirects
FOUR_SELECTORS = ("ind_skip_1_2_3_4", "ind_skip_0_2_3_4", "ind_skip_0_1_3_4", "ind_skip_0_1_2_4")
# tools/tpu_quality.py:146-147, the sparse models that `tuned` keeps at the
# reference sizing and takes out of the lane rotation
TUNED_KEEP = ("ind_5b_15", "ind_6b_15") + FOUR_SELECTORS


def _validated(spec: EnsembleSpec) -> EnsembleSpec:
    spec.validate()
    return spec


def ladder(spec: EnsembleSpec, variant: str) -> EnsembleSpec:
    """tools/tpu_fast_ladder.py:58 `trim_spec`: `base` as it is; `no4sel`
    without the four four-byte-selector skip indirects; `noskipind` without
    every `ind_skip_*` model (their contexts stay: mixers gate on them);
    `noih` without the `ind_ih_*` models (their contexts stay); `nolstm`
    without the LSTM and the models and mixers gated on `lstm_ctx`;
    `noskipind-noih` both; `lean` noskipind + noih + nolstm."""
    if variant not in LADDER:
        raise ValueError(f"unknown ladder variant {variant!r}: one of {', '.join(LADDER)}")
    drop = set()
    if variant == "no4sel":
        drop = set(FOUR_SELECTORS)
    elif variant in ("noskipind", "noskipind-noih", "lean"):
        drop = {m.name for m in spec.indirects if m.name.startswith("ind_skip_")}
    if variant in ("noih", "noskipind-noih", "lean"):
        drop |= {m.name for m in spec.indirects if m.name.startswith("ind_ih_")}
    out = spec
    if drop:
        out = replace(out, indirects=tuple(m for m in out.indirects if m.name not in drop))
    if variant in ("nolstm", "lean"):
        out = replace(out, lstm=None, indirects=tuple(m for m in out.indirects if m.ctx != "lstm_ctx"),
                       mixers=tuple(m for m in out.mixers if m.ctx != "lstm_ctx"))
    return _validated(out)


def _first_mixers(spec: EnsembleSpec, n0: int, n1: int):
    """The first n0 layer-0 and n1 layer-1 mixers, and the final one."""
    return spec.mixers_in_layer(0)[:n0] + spec.mixers_in_layer(1)[:n1] + spec.mixers_in_layer(2)


def ablate(spec: EnsembleSpec, variant: str) -> EnsembleSpec:
    """tools/tpu_ablate.py:21 `variant` on `spec`: `full` as it is;
    `nolstm`, `noppm`, `nolstmppm` without the LSTM, PPM or both (the
    models, mixers and rolling contexts gated on them stay); `nomatch`
    without the match models; `noih` without the indirect-hash contexts and
    their models, their mixers gated on `last_byte`; `nomix12` one mixer in
    layers 0 and 1; `mixtb0` / `mixtb4` every mixer's gating table at 1 row /
    at most 16 rows; `mix6` 6 mixers in layer 0 and 2 in layer 1; `indonly`
    the indirect models without the IH ones, one mixer a layer gated on
    `last_byte`, no LSTM, PPM, match models or IH contexts."""
    if variant not in ABLATE:
        raise ValueError(f"unknown ablate variant {variant!r}: one of {', '.join(ABLATE)}")
    s = spec
    if variant == "nolstm":
        s = replace(s, lstm=None)
    elif variant == "noppm":
        s = replace(s, ppm=None)
    elif variant == "nolstmppm":
        s = replace(s, lstm=None, ppm=None)
    elif variant == "nomatch":
        s = replace(s, matches=())
    elif variant == "noih":
        s = replace(s, ihash_ctxs=(), indirects=tuple(m for m in s.indirects if not m.ctx.startswith("ih_")),
                     mixers=tuple(replace(m, ctx="last_byte") if m.ctx.startswith("ih_") else m for m in s.mixers))
    elif variant == "nomix12":
        s = replace(s, mixers=_first_mixers(s, 1, 1))
    elif variant == "mixtb0":
        s = replace(s, mixers=tuple(replace(m, table_bits=0) for m in s.mixers))
    elif variant == "mixtb4":
        s = replace(s, mixers=tuple(replace(m, table_bits=min(m.table_bits, 4)) for m in s.mixers))
    elif variant == "mix6":
        s = replace(s, mixers=_first_mixers(s, 6, 2))
    elif variant == "indonly":
        s = replace(s, lstm=None, ppm=None, matches=(), ihash_ctxs=(),
                     indirects=tuple(m for m in s.indirects if not m.ctx.startswith("ih_")),
                     mixers=tuple(replace(m, ctx="last_byte") for m in _first_mixers(s, 1, 1)))
    return _validated(s)


def old_ppm() -> PpmSpec:
    """tools/tpu_quality.py:38 `_old_ppm`: five shallow orders, no
    exclusion, no update exclusion, no SEE learning."""
    return PpmSpec(orders=(PpmOrder("last_byte", 8), PpmOrder("h2", 16), PpmOrder("h3", 16), PpmOrder("h4", 16),
                           PpmOrder("h6", 16)),
                   see_lr=0.0, exclusion=False, update_exclusion=False)


def _resized(spec: EnsembleSpec, ind_bits, ppm_bits: int, keep=()) -> EnsembleSpec:
    """`spec` with each indirect model's table at `ind_bits(bits)` (a model
    named in `keep` at its size, out of the lane rotation) and each PPM
    order of 16 bits or more at `ppm_bits`."""
    return replace(
        spec,
        indirects=tuple(replace(m, rotate=False) if m.name in keep else replace(m, table_bits=ind_bits(m.table_bits))
                        for m in spec.indirects),
        ppm=replace(spec.ppm, orders=tuple(replace(o, table_bits=ppm_bits) if o.table_bits >= 16 else o
                                            for o in spec.ppm.orders)))


def boost117() -> EnsembleSpec:
    """tools/tpu_quality.py:57 `_boost117`: the reference wiring with every
    indirect table one bit larger (at most 18) and the PPM orders of 16 bits
    or more at 17."""
    return _resized(reference_spec(), lambda b: min(b + 1, 18), 17)


def _int(text: str, name: str) -> int:
    if not text.isdigit():
        raise ValueError(f"quality variant {name!r}: {text!r} is not a number")
    return int(text)


def _streams(text: str, name: str) -> int:
    """`x<S>` -> S."""
    if not text.startswith("x"):
        raise ValueError(f"quality variant {name!r}: expected x<streams>, got {text!r}")
    return _int(text[1:], name)


def _bits_streams(text: str, name: str) -> Tuple[int, int]:
    """`<bits>x<S>` -> (bits, S)."""
    bits, sep, S = text.partition("x")
    if not sep:
        raise ValueError(f"quality variant {name!r}: expected <bits>x<streams>, got {text!r}")
    return _int(bits, name), _int(S, name)


def _parts(name: str, n: int) -> list:
    parts = name.split("-")
    if len(parts) != n:
        raise ValueError(f"quality variant {name!r}: expected {n} fields separated by '-'")
    return parts


def quality(name: str) -> Tuple[EnsembleSpec, int]:
    """tools/tpu_quality.py:81 `make_variant`: (spec, streams) of a variant
    name. Families: `apm-<lr_milli>-<wgt_pct>-<tb>x<S>` (`boost117()` and
    one SSE/APM stage on `last_byte`; `apm2-...` a second on `h2` at tb + 8
    bits and half the weight), `shallowppm-<bits>x<S>` (scaled, the five
    shallow PPM orders with SEE and both exclusions kept), `boost-<add>-
    <ppm_bits>x<S>` (indirect tables `add` bits larger, at most 18; the PPM
    orders of 16 bits or more at ppm_bits), `best-x<S>` (`best_spec()`),
    `tuned-x<S>` (PPM at 17 bits, +1 bit for the dense indirect tables, the
    sparse ones at the reference sizing without rotation), `ppmtune-<inc>-
    <rescale_total>-<see_lr_milli>x<S>` (the PPM's counts), `ref-x<S>` (the
    reference wiring) and `scaled-<bits>x<S>` (its tables clamped), the
    last two with an optional `-noppm` (PPM removed) or `-oldppm`
    (`old_ppm()`)."""
    if name.startswith("apm"):
        lr_milli, wgt_pct, rest = _parts(name, 4)[1:]
        tb, S = _bits_streams(rest, name)
        lr, wgt = _int(lr_milli, name) / 1000.0, _int(wgt_pct, name) / 100.0
        stages = (ApmStage("apm_lb", "last_byte", tb, lr=lr, weight=wgt),)
        if name.startswith("apm2-"):
            stages += (ApmStage("apm_h2", "h2", tb + 8, lr=lr, weight=wgt / 2),)
        elif not name.startswith("apm-"):
            raise ValueError(f"unknown quality variant {name!r}")
        return _validated(replace(boost117(), apm=stages)), S
    if name.startswith("shallowppm-"):
        bits, S = _bits_streams(_parts(name, 2)[1], name)
        spec = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
        orders = tuple(PpmOrder(c, min(b, bits))
                       for c, b in (("last_byte", 8), ("h2", 16), ("h3", 16), ("h4", 16), ("h6", 16)))
        return _validated(replace(spec, ppm=replace(spec.ppm, orders=orders))), S
    if name.startswith("boost-"):
        ind_add, rest = _parts(name, 3)[1:]
        ppm_bits, S = _bits_streams(rest, name)
        add = _int(ind_add, name)
        return _validated(_resized(reference_spec(), lambda b: min(b + add, 18), ppm_bits)), S
    if name.startswith("best-"):
        return _validated(best_spec()), _streams(_parts(name, 2)[1], name)
    if name.startswith("tuned-"):
        S = _streams(_parts(name, 2)[1], name)
        return _validated(_resized(reference_spec(), lambda b: min(b + 1, 18), 17, keep=TUNED_KEEP)), S
    if name.startswith("ppmtune-"):
        inc, rescale, rest = _parts(name, 4)[1:]
        see_milli, S = _bits_streams(rest, name)
        spec = reference_spec()
        ppm = replace(spec.ppm, inc=_int(inc, name), rescale_total=_int(rescale, name),
                       see_lr=see_milli / 1000.0)
        return _validated(replace(spec, ppm=ppm)), S
    parts = name.split("-")
    if parts[0] == "ref" and len(parts) in (2, 3):
        spec, S = reference_spec(), _streams(parts[1], name)
    elif parts[0] == "scaled" and len(parts) in (2, 3):
        bits, S = _bits_streams(parts[1], name)
        spec = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
    else:
        raise ValueError(f"unknown quality variant {name!r}: apm-, apm2-, shallowppm-, boost-, best-, tuned-, "
                         f"ppmtune-, ref-x<S> or scaled-<bits>x<S> (tools/tpu_quality.py)")
    mod = parts[2] if len(parts) == 3 else ""
    if mod == "noppm":
        spec = replace(spec, ppm=None)
    elif mod == "oldppm":
        spec = replace(spec, ppm=old_ppm())
    elif mod:
        raise ValueError(f"quality variant {name!r}: unknown suffix -{mod} (-noppm or -oldppm)")
    return _validated(spec), S
