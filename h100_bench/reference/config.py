# Frozen copy of gmix_tpu_torch/config.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
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
import sys
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


def spec_from_dict(d: dict, classes=None) -> EnsembleSpec:
    """The spec whose `dataclasses.asdict` is `d` (a configuration file's
    `spec`): every nested group rebuilt as its dataclass, lists as tuples.
    `classes` is the module whose dataclasses build it (default: this
    one's)."""
    c = sys.modules[__name__] if classes is None else classes
    EnsembleSpec, SkipCtx, IntervalCtx, IndirectHashCtx = c.EnsembleSpec, c.SkipCtx, c.IntervalCtx, c.IndirectHashCtx
    IndirectModel, MatchModel, MixerModel, ApmStage = c.IndirectModel, c.MatchModel, c.MixerModel, c.ApmStage
    PpmOrder, PpmSpec, LstmSpec, RollHashCtx = c.PpmOrder, c.PpmSpec, c.LstmSpec, c.RollHashCtx

    def many(cls, rows):
        return tuple(cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in r.items()}) for r in rows)

    ppm = d.get("ppm")
    if ppm is not None:
        ppm = PpmSpec(**{**ppm, "orders": many(PpmOrder, ppm["orders"])})
    spec = EnsembleSpec(
        skip_ctxs=many(SkipCtx, d["skip_ctxs"]),
        interval_ctxs=many(IntervalCtx, d["interval_ctxs"]),
        ihash_ctxs=many(IndirectHashCtx, d["ihash_ctxs"]),
        indirects=many(IndirectModel, d["indirects"]),
        matches=many(MatchModel, d["matches"]),
        mixers=many(MixerModel, d["mixers"]),
        lstm=LstmSpec(**d["lstm"]) if d.get("lstm") is not None else None,
        ppm=ppm,
        history_bits=d["history_bits"],
        roll_ctxs=many(RollHashCtx, d["roll_ctxs"]),
        apm=many(ApmStage, d["apm"]),
        prefix_inputs=d["prefix_inputs"],
    )
    spec.validate()
    return spec
