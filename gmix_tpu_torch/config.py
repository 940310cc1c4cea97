"""Ensemble specification: the full model wiring as data.

Carried over field for field from `gmix_tpu.config`, which the port cannot
import (that package imports JAX). The dataclasses, their field order and
their defaults must stay identical: `EnsembleSpec.stable_hash()` is written
into the GXTC container header, and `core/meta.py` derives the arena layouts
(and so the checkpoints) from these values.

Terminology:
- "context": a uint32 per stream, recomputed at byte boundaries (hashes,
  intervals, indirect hashes) or per bit (bit_ctx and composites).
- "indirect model": a (nonstationary, run-map) state-table pair over one
  context, contributing TWO logit predictions (src/models/indirect.cpp).
- "match model": history-pointer predictor (src/models/match.cpp).
- "mixer": one context-gated linear unit in the 3-layer GLN
  (src/mixer/mixer.cpp).

Built-in context names always available to models:
  zero, bit_ctx, last_byte, lb_recent, slb_recent, recent_1..recent_9,
  longest_match, lstm_ctx
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple

BUILTIN_CTXS: Tuple[str, ...] = (
    "zero",
    "bit_ctx",
    "last_byte",
    "lb_recent",
    "slb_recent",
    "recent_1",
    "recent_2",
    "recent_3",
    "recent_4",
    "recent_5",
    "recent_6",
    "recent_7",
    "recent_8",
    "recent_9",
    "longest_match",
    "lstm_ctx",
)


@dataclass(frozen=True)
class SkipCtx:
    """Murmur hash of selected recent bytes (src/contexts/skip-context.cpp:9-19).

    offsets[i] is "bytes ago" (0 = last byte); bytes are packed big-endian into
    a u64 in list order, then hashed.
    """

    name: str
    offsets: Tuple[int, ...]


@dataclass(frozen=True)
class IntervalCtx:
    """Quantised-byte rolling context (src/contexts/interval-context.cpp)."""

    name: str
    divisor: int  # byte state = byte // divisor
    num_bits: int  # rolling context width


@dataclass(frozen=True)
class IndirectHashCtx:
    """History-of-what-followed context (src/contexts/indirect-hash.cpp)."""

    name: str
    outer_order: int
    table_bits: int
    inner_order: int


@dataclass(frozen=True)
class RollHashCtx:
    """Incremental Rabin-Karp hash of EXACTLY the last `order` bytes.

    The reference's skip-context packing caps at 8 bytes (a u64 key,
    src/contexts/skip-context.h); deep PPM orders need byte windows past
    that, so this context maintains h = sum_i recent[i] * B^i mod 2^32
    with an O(1) per-byte update (subtract the leaving byte's B^(order-1)
    term, multiply by B, add the entering byte) and publishes
    murmur-finalised h: one elementwise update across all instances and
    streams per byte.
    """

    name: str
    order: int


@dataclass(frozen=True)
class IndirectModel:
    """Two-state-machine indirect predictor (src/models/indirect.cpp).

    Table size is (1 << table_bits) * 256 + 1 (the +1 breaks byte-context
    collision alignment, indirect.cpp:15-19).

    `rotate` enables the hash-derived lane rotation (the power-of-two
    arena's equivalent of the +1 sizing; see core/step.py). The derangement
    helps dense tables but destroys the collision-sharing "backoff" of
    SPARSE deep-order contexts, so sparse models can opt out.
    """

    name: str
    ctx: str
    table_bits: int
    lr: float
    rotate: bool = True


@dataclass(frozen=True)
class MatchModel:
    """History-match predictor (src/models/match.cpp). Table size 1<<table_bits."""

    name: str
    ctx: str
    table_bits: int
    limit: int = 400


@dataclass(frozen=True)
class MixerModel:
    """One gated-linear mixer unit (src/mixer/mixer.cpp). Table size 1<<table_bits.

    `pos=True` gates the unit on (ctx, bit position): the weight row for a
    byte-stable ctx is an 8-sub-row block, one per bit position of the byte.
    This redesigns the reference's bit-varying mixer gates (bit_ctx /
    lb_recent / slb_recent, predictor.cpp:262-356): a bit-prefix-gated table
    needs a fresh scattered row EVERY BIT, while a position block moves once
    per byte. The dropped bit-prefix information is re-supplied to every
    mixer as linear input features (EnsembleSpec.prefix_inputs)."""

    name: str
    ctx: str
    lr: float
    layer: int  # 0, 1, or 2 (final)
    table_bits: int
    pos: bool = False


@dataclass(frozen=True)
class ApmStage:
    """One SSE/APM final-probability refinement stage.

    The standard cmix/paq adaptive-probability-map trick the reference LACKS
    (its final path is a bare clamp of the mixer output,
    src/predictor.cpp:360-376): a per-(context, bit-position) table maps the
    quantized mixer probability to a learned refined probability, with linear
    interpolation between adjacent quantization bins and an online update of
    the two bins toward the observed bit. The table row for a byte-stable
    gating context is gathered once per byte, read/updated across the 8 bit
    sub-steps, and scattered back once per byte (one extra arena row per
    stage per byte).

    Bins quantize logit(p) over [-APM_SPAN, APM_SPAN] into APM_BINS-1 cells;
    each row holds APM_BINS probabilities per bit position (position-aware
    calibration; 8*APM_BINS lanes per row). `weight` blends the refined
    probability with the stage input in probability domain:
    out = weight*apm + (1-weight)*in. Stages chain in order.
    """

    name: str
    ctx: str
    table_bits: int
    lr: float = 0.02
    weight: float = 0.75


@dataclass(frozen=True)
class PpmOrder:
    ctx: str  # context slot providing the hashed byte context
    table_bits: int  # 2^bits rows of 256 counts


@dataclass(frozen=True)
class PpmSpec:
    """Device-native PPM byte model.

    Functional equivalent of the reference's ModPPMD (src/models/mod_ppmd.cpp):
    produces a 256-way next-byte distribution every byte (consumed by its own
    bit predictor and as the LSTM's aux input, lstm-model.cpp:21). The
    reference's pointer-chasing suffix-tree suballocator is not expressible
    as batched device work (and a host round-trip per byte would serialise
    decode), so this is a re-design over hashed fixed-order count tables with
    the three PPMd mechanisms that carry its quality, all dense-vectorised:

    - blending runs HIGHEST order first with symbol exclusion: symbols seen at
      a higher order are masked out of every lower order's counts and escape
      estimate (PPMd's exclusion list, mod_ppmd.cpp:1192-1220);
    - escapes are adaptive: esc = sigmoid(logit(ppmc) + adj[order, bucket])
      where ppmc is the PPM-C prior distinct/(total+distinct) and adj is an
      online-learned correction bucketed by (order, distinct-count) — the
      SEE mechanism (mod_ppmd.cpp:465-496, 1024-1175) reduced to a learned
      logistic offset;
    - update exclusion: counts update only at orders >= the order that coded
      the byte (PPMd updates the matched context and its escaping parents,
      not the shorter ones, mod_ppmd.cpp:498-660).
    """

    orders: Tuple[PpmOrder, ...] = (
        PpmOrder("last_byte", 8),
        PpmOrder("h2", 16),
        PpmOrder("h3", 16),
        PpmOrder("h4", 16),
        PpmOrder("h5", 16),
        PpmOrder("h6", 16),
        PpmOrder("roll_8", 16),
        PpmOrder("roll_12", 16),
        PpmOrder("roll_20", 16),
    )
    inc: int = 4  # count increment per observed byte
    rescale_total: int = 48000  # halve a row when its total exceeds this
    see_buckets: int = 16  # distinct-count buckets per order
    see_lr: float = 0.02  # online lr of the escape correction
    exclusion: bool = True  # symbol exclusion across orders
    update_exclusion: bool = True  # PPMd-style update exclusion


@dataclass(frozen=True)
class LstmSpec:
    """CIFG LSTM byte model (src/models/lstm-model.cpp:7, lstm-layer.cpp)."""

    num_cells: int = 50
    horizon: int = 100
    lr: float = 0.03
    grad_clip: float = 10.0
    adam_beta1: float = 0.025
    adam_beta2: float = 0.9999
    adam_eps: float = 1e-6
    update_limit: int = 3000
    input_size: int = 256  # aux input width (PPM byte distribution)
    output_size: int = 256


@dataclass(frozen=True)
class EnsembleSpec:
    skip_ctxs: Tuple[SkipCtx, ...]
    interval_ctxs: Tuple[IntervalCtx, ...]
    ihash_ctxs: Tuple[IndirectHashCtx, ...]
    indirects: Tuple[IndirectModel, ...]
    matches: Tuple[MatchModel, ...]
    mixers: Tuple[MixerModel, ...]
    lstm: Optional[LstmSpec] = LstmSpec()
    ppm: Optional[PpmSpec] = None  # PPM byte model (feeds ppm_probs)
    history_bits: int = 24  # dedup history ring size (reference: unbounded)
    roll_ctxs: Tuple[RollHashCtx, ...] = ()  # deep-order rolling-hash contexts
    apm: Tuple[ApmStage, ...] = ()  # SSE/APM final-probability stages
    # feed the current byte's known bit prefix (+-1 per seen bit position,
    # 0 for unseen) as 8 extra input lanes to every mixer - the linear-input
    # form of the bit-prefix information that position-gated mixers
    # (MixerModel.pos) no longer carry in their gate
    prefix_inputs: bool = True

    @property
    def use_ppm(self) -> bool:
        return self.ppm is not None

    # ---- derived helpers ----
    def ctx_names(self) -> Tuple[str, ...]:
        names = list(BUILTIN_CTXS)
        names += [c.name for c in self.skip_ctxs]
        names += [c.name for c in self.interval_ctxs]
        names += [c.name for c in self.ihash_ctxs]
        names += [c.name for c in self.roll_ctxs]
        assert len(names) == len(set(names)), "duplicate context names"
        return tuple(names)

    def ctx_slot(self, name: str) -> int:
        return self.ctx_names().index(name)

    @property
    def num_ctx(self) -> int:
        return len(self.ctx_names())

    @property
    def num_predictions(self) -> int:
        n = 2 * len(self.indirects) + len(self.matches)
        if self.lstm is not None:
            n += 1
        if self.use_ppm:
            n += 1
        return n

    # Prediction-column layout: [ppm?, lstm?, indirect pairs..., matches...]
    @property
    def ppm_col(self) -> Optional[int]:
        return 0 if self.use_ppm else None

    @property
    def lstm_col(self) -> Optional[int]:
        if self.lstm is None:
            return None
        return 1 if self.use_ppm else 0

    @property
    def ind_col0(self) -> int:
        return int(self.use_ppm) + int(self.lstm is not None)

    @property
    def match_col0(self) -> int:
        return self.ind_col0 + 2 * len(self.indirects)

    @property
    def skip_connection_cols(self) -> Tuple[int, ...]:
        """Model columns fed to L1/final mixers directly (reference: LSTM only,
        src/models/lstm-model.cpp:14)."""
        return (self.lstm_col,) if self.lstm_col is not None else ()

    def mixers_in_layer(self, layer: int) -> Tuple[MixerModel, ...]:
        return tuple(m for m in self.mixers if m.layer == layer)

    def mixer_width(self, layer: int) -> int:
        """Unpadded input width of a layer's weight vectors (mixer.cpp:17-26),
        plus the 8 prefix-input lanes when enabled."""
        n0 = len(self.mixers_in_layer(0))
        n1 = len(self.mixers_in_layer(1))
        ns = len(self.skip_connection_cols)
        pf = 8 if self.prefix_inputs else 0
        if layer == 0:
            return self.num_predictions + n0 + pf
        if layer == 1:
            return n0 + n1 + ns + pf
        return n0 + n1 + ns + pf

    def validate(self) -> None:
        names = set(self.ctx_names())
        for m in list(self.indirects) + list(self.matches) + list(self.mixers):
            assert m.ctx in names, f"unknown context {m.ctx!r} in {m.name}"
        if self.ppm is not None:
            for o in self.ppm.orders:
                assert o.ctx in names, f"unknown context {o.ctx!r} in ppm"
        assert len(self.mixers_in_layer(2)) == 1, "exactly one final mixer required"
        # the only bit-varying mixer gate is longest_match (a small table
        # kept dense-resident); the reference's other bit-varying gates are
        # expressed as position-gated mixers on byte-stable contexts
        # (MixerModel.pos) instead
        for m in self.mixers:
            assert m.ctx not in {"bit_ctx", "lb_recent", "slb_recent"}, (
                f"{m.name}: bit-prefix mixer gates are expressed as pos=True "
                "on the byte-stable base context (see MixerModel.pos)"
            )
            if m.ctx == "longest_match":
                assert m.table_bits <= 5 and not m.pos, (
                    f"{m.name}: longest_match mixers are dense-resident "
                    "(table_bits <= 5, pos unsupported)"
                )
        vary = {"bit_ctx", "lb_recent", "slb_recent", "longest_match"}
        for m in list(self.indirects) + list(self.matches):
            assert m.ctx not in vary, (
                f"{m.name}: bit-varying context {m.ctx!r} is only supported "
                "as a mixer gate"
            )
        if self.ppm is not None:
            for o in self.ppm.orders:
                assert o.ctx not in vary, "ppm orders need byte-stable contexts"
        for a in self.apm:
            assert a.ctx in names, f"unknown context {a.ctx!r} in apm {a.name}"
            assert a.ctx not in vary, (
                f"apm {a.name}: gating context must be byte-stable (the row "
                "is gathered once per byte; bit-position awareness is built "
                "into the row layout)"
            )

    def stable_hash(self) -> int:
        """Stable 64-bit digest of the spec, embedded in the container format."""
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return int.from_bytes(hashlib.sha256(blob.encode()).digest()[:8], "little")


def scale_tables(spec: EnsembleSpec, max_bits: int, history_bits: Optional[int] = None) -> EnsembleSpec:
    """Clamp every table size to 2^max_bits entries - the memory knob that
    trades per-stream state for stream count (SURVEY.md 7, hard part 4)."""
    return dataclasses.replace(
        spec,
        ihash_ctxs=tuple(
            dataclasses.replace(c, table_bits=min(c.table_bits, max_bits)) for c in spec.ihash_ctxs
        ),
        indirects=tuple(
            dataclasses.replace(m, table_bits=min(m.table_bits, max_bits)) for m in spec.indirects
        ),
        matches=tuple(
            dataclasses.replace(m, table_bits=min(m.table_bits, max_bits)) for m in spec.matches
        ),
        mixers=tuple(
            dataclasses.replace(m, table_bits=min(m.table_bits, max_bits)) for m in spec.mixers
        ),
        ppm=dataclasses.replace(
            spec.ppm,
            orders=tuple(
                dataclasses.replace(o, table_bits=min(o.table_bits, max_bits))
                for o in spec.ppm.orders
            ),
        )
        if spec.ppm is not None
        else None,
        apm=tuple(
            dataclasses.replace(a, table_bits=min(a.table_bits, max_bits))
            for a in spec.apm
        ),
        history_bits=min(spec.history_bits, history_bits if history_bits is not None else spec.history_bits),
    )


def reference_spec() -> EnsembleSpec:
    """The full reference ensemble wiring (src/predictor.cpp:17-358):
    41 indirect models (82 predictions), 6 match models, LSTM, 24+8+1 mixers,
    and the device-native PPM byte model (whose distribution also feeds the
    LSTM aux input, mirroring lstm-model.cpp:21).
    """
    skips = (
        # consecutive-byte hashes (predictor.cpp:84-107)
        SkipCtx("h2", (0, 1)),
        SkipCtx("h3", (0, 1, 2)),
        SkipCtx("h4", (0, 1, 2, 3)),
        SkipCtx("h5", (0, 1, 2, 3, 4)),
        SkipCtx("h6", (0, 1, 2, 3, 4, 5)),
        # skip patterns (predictor.cpp:122-185)
        SkipCtx("skip_1_2", (1, 2)),
        SkipCtx("skip_1_2_3", (1, 2, 3)),
        SkipCtx("skip_0_2", (0, 2)),
        SkipCtx("skip_0_2_3", (0, 2, 3)),
        SkipCtx("skip_1_2_3_4", (1, 2, 3, 4)),
        SkipCtx("skip_0_3", (0, 3)),
        SkipCtx("skip_0_4", (0, 4)),
        SkipCtx("skip_0_5", (0, 5)),
        SkipCtx("skip_0_2_3_4", (0, 2, 3, 4)),
        SkipCtx("skip_0_3_4", (0, 3, 4)),
        SkipCtx("skip_0_6", (0, 6)),
        SkipCtx("skip_0_7", (0, 7)),
        SkipCtx("skip_0_1_3_4", (0, 1, 3, 4)),
        SkipCtx("skip_0_4_5", (0, 4, 5)),
        SkipCtx("skip_0_1_2_4", (0, 1, 2, 4)),
    )
    intervals = tuple(
        IntervalCtx(f"int_{d}_{b}", d, b)
        for d, bs in ((16, (4, 8, 12)), (32, (3, 6, 12)), (64, (4, 8, 12)))
        for b in bs
    )  # predictor.cpp:54-76
    ihashes = (
        IndirectHashCtx("ih_1_8_1", 1, 8, 1),
        IndirectHashCtx("ih_1_8_2", 1, 8, 2),
        IndirectHashCtx("ih_1_8_3", 1, 8, 3),
        IndirectHashCtx("ih_2_16_1", 2, 16, 1),
        IndirectHashCtx("ih_2_16_2", 2, 16, 2),
        IndirectHashCtx("ih_2_16_3", 2, 16, 3),
        IndirectHashCtx("ih_3_24_1", 3, 24, 1),
        IndirectHashCtx("ih_4_24_2", 4, 24, 2),
        IndirectHashCtx("ih_4_24_3", 4, 24, 3),
    )  # predictor.cpp:213-248

    lr_d = 0.02  # direct/skip indirect lr (predictor.cpp:79, 123)
    lr_i = 1.0 / 200  # double-indirect lr (predictor.cpp:211)
    indirects = (
        (
            IndirectModel("ind_1b", "last_byte", 8, lr_d),
            IndirectModel("ind_2b", "h2", 16, lr_d),
            IndirectModel("ind_3b_15", "h3", 15, lr_d),
            IndirectModel("ind_3b_16", "h3", 16, lr_d),
            IndirectModel("ind_4b_15", "h4", 15, lr_d),
            IndirectModel("ind_5b_15", "h5", 15, lr_d),
            IndirectModel("ind_6b_15", "h6", 15, lr_d),
        )
        + tuple(IndirectModel(f"ind_recent_{i}", f"recent_{i}", 8, lr_d) for i in range(1, 10))
        + (IndirectModel("ind_lstm", "lstm_ctx", 8, lr_d),)
        + tuple(
            IndirectModel(f"ind_{s.name}", s.name, 16, lr_d)
            for s in skips
            if s.name.startswith("skip_")
        )
        + tuple(IndirectModel(f"ind_{c.name}", c.name, tb, lr_i) for c, tb in zip(ihashes, (8, 16, 15, 8, 16, 15, 8, 16, 15)))
    )
    matches = (
        MatchModel("match_1b", "last_byte", 8),
        MatchModel("match_2b", "h2", 16),
        MatchModel("match_3b", "h3", 24),
        MatchModel("match_4b", "h4", 21),
        MatchModel("match_5b", "h5", 21),
        MatchModel("match_6b", "h6", 21),
    )  # predictor.cpp:187-208
    def _mk(prefix, layer, rows):
        out = []
        for i, row in enumerate(rows):
            ctx, lr, tb = row[:3]
            pos = bool(row[3]) if len(row) > 3 else False
            out.append(MixerModel(f"{prefix}{i}", ctx, lr, layer, tb, pos=pos))
        return tuple(out)

    mixers = _mk("mix0_", 0,
            (
                ("last_byte", 0.005, 8),
                ("recent_3", 0.0055, 8),
                ("recent_1", 0.003, 8, True),  # was slb_recent (2nd-last-byte x bit prefix)
                ("h4", 0.0045, 15),
                ("ih_3_24_1", 0.006, 8),
                ("recent_1", 0.004, 8),
                ("longest_match", 0.0005, 3),
                ("h2", 0.0035, 16),
                ("recent_2", 0.0065, 8),
                ("h3", 0.0025, 15),
                ("last_byte", 0.001, 8),
                ("last_byte", 0.002, 8, True),  # was lb_recent (last-byte x bit prefix)
                ("int_16_4", 0.005, 4),
                ("int_16_8", 0.0045, 8),
                ("int_16_12", 0.0055, 12),
                ("int_32_3", 0.004, 3),
                ("int_32_6", 0.0035, 6),
                ("skip_0_2", 0.006, 16),
                ("int_32_12", 0.003, 12),
                ("int_64_4", 0.0065, 4),
                ("int_64_8", 0.003, 8),
                ("int_64_12", 0.0025, 12),
                ("lstm_ctx", 0.002, 8),
                ("zero", 0.0005, 0),
            )
    ) + _mk("mix1_", 1,
            (
                ("recent_1", 0.0045, 8),
                ("zero", 0.0035, 0),
                ("zero", 0.003, 0, True),  # was bit_ctx
                ("recent_2", 0.002, 8),
                ("last_byte", 0.0025, 8),
                ("zero", 0.00001, 0, True),  # was bit_ctx
                ("longest_match", 0.0008, 3),
                ("zero", 0.0004, 0),
            )
    ) + (
        MixerModel("mix_final", "zero", 0.0005, 2, 0),
    )  # predictor.cpp:251-358

    spec = EnsembleSpec(
        skip_ctxs=skips,
        interval_ctxs=intervals,
        ihash_ctxs=ihashes,
        indirects=indirects,
        matches=matches,
        mixers=mixers,
        lstm=LstmSpec(),
        ppm=PpmSpec(),
        history_bits=24,
        roll_ctxs=(
            RollHashCtx("roll_8", 8),
            RollHashCtx("roll_12", 12),
            RollHashCtx("roll_20", 20),
        ),
    )
    spec.validate()
    return spec


def best_spec() -> EnsembleSpec:
    """The measured-best compression-quality wiring (round 4): the reference
    ensemble with every indirect table grown one bit (cap 18), 17-bit hashed
    PPM orders, two SSE/APM stages, and a 64 MB match-history ring. On
    corpus_1m at 4 streams this reaches 2.0153 bpb vs 2.0318 for the
    reference binary on the same 4-way-split input - 0.8% BETTER than the
    reference at equal parallelism (data/quality_ablations.json
    `apm2-10-50-8x4`; best_spec == that spec + the larger history ring)."""
    import dataclasses as _dc

    spec = reference_spec()
    spec = _dc.replace(
        spec,
        indirects=tuple(
            _dc.replace(m, table_bits=min(m.table_bits + 1, 18)) for m in spec.indirects
        ),
        ppm=_dc.replace(
            spec.ppm,
            # 17-bit hashed orders (kept identical to gmix_tpu.config so the
            # spec hash agrees)
            orders=tuple(
                _dc.replace(o, table_bits=17) if o.table_bits >= 16 else o
                for o in spec.ppm.orders
            ),
        ),
        # two SSE/APM final-probability stages (measured -0.015 bpb on
        # corpus_1m x4: 2.0301 -> 2.0153; the lr=0.010 / weight 0.50+0.25
        # point won the round-4 sweep, data/quality_ablations.json)
        apm=(
            ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
            ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
        ),
        # a 64 MB dedup-history ring per stream: the reference's match
        # history is unbounded (match.cpp:92-108 + 5-byte pointers); 2^26
        # covers the full range of >=16 MB inputs at small stream counts
        history_bits=26,
    )
    spec.validate()
    return spec


def tiny_spec(with_lstm: bool = False) -> EnsembleSpec:
    """A small-but-representative spec for unit tests: every model kind and
    every context kind is exercised, with tiny tables."""
    skips = (
        SkipCtx("h2", (0, 1)),
        SkipCtx("h3", (0, 1, 2)),
        SkipCtx("skip_0_2", (0, 2)),
    )
    intervals = (IntervalCtx("int_16_4", 16, 4),)
    ihashes = (IndirectHashCtx("ih_1_6_1", 1, 6, 1),)
    indirects = (
        IndirectModel("ind_1b", "last_byte", 4, 0.02),
        IndirectModel("ind_2b", "h2", 6, 0.02),
        IndirectModel("ind_3b", "h3", 6, 0.02),
        IndirectModel("ind_skip", "skip_0_2", 6, 0.02),
        IndirectModel("ind_ih", "ih_1_6_1", 4, 1.0 / 200),
        IndirectModel("ind_recent_1", "recent_1", 4, 0.02),
    )
    matches = (
        MatchModel("match_2b", "h2", 8),
        MatchModel("match_3b", "h3", 8),
    )
    mixers = (
        MixerModel("mix0_0", "last_byte", 0.005, 0, 8),
        MixerModel("mix0_1", "h2", 0.0035, 0, 8),
        MixerModel("mix0_2", "int_16_4", 0.005, 0, 4),
        MixerModel("mix0_3", "zero", 0.0005, 0, 0),
        # one mixer per remaining placement class (core/meta.py), so the CPU
        # suite's roundtrip/checkpoint/copy invariants exercise all five:
        # pos=True with a table -> the flat position-block arena (mix_pos),
        # longest_match gating -> the dense-carried lm class
        MixerModel("mix0_pos", "h2", 0.004, 0, 3, pos=True),
        MixerModel("mix0_lm", "longest_match", 0.0008, 0, 3),
        MixerModel("mix1_0", "zero", 0.003, 1, 0, pos=True),
        MixerModel("mix1_1", "zero", 0.0035, 1, 0),
        MixerModel("mix_final", "zero", 0.0005, 2, 0),
    )
    spec = EnsembleSpec(
        skip_ctxs=skips,
        interval_ctxs=intervals,
        ihash_ctxs=ihashes,
        indirects=indirects,
        matches=matches,
        mixers=mixers,
        apm=(
            ApmStage("apm_lb", "last_byte", 4),
            ApmStage("apm_h2", "h2", 6, weight=0.5),
        ),
        lstm=LstmSpec(num_cells=16, horizon=10, update_limit=30) if with_lstm else None,
        ppm=PpmSpec(
            orders=(
                PpmOrder("last_byte", 4),
                PpmOrder("h2", 6),
                PpmOrder("roll_4", 6),
            ),
            see_buckets=8,
        )
        if with_lstm
        else None,
        history_bits=12,
        roll_ctxs=(RollHashCtx("roll_4", 4),) if with_lstm else (),
    )
    spec.validate()
    return spec
