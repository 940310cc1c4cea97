"""`ablate-nomatch` and `ablate-mixtb0` (gmix_tpu_torch/variants.py), with
the LSTM, at 8-bit tables: ~200 bytes coded by the port within 1% in size
and 0.5% in cross-entropy of jitted gmix_tpu (contract 3: the LSTM's sums
are fixed trees here, XLA's order there), the same container header, and
decoded exactly. Their specs against tools/tpu_ablate.py's and the other
variants: tests/test_torch_variants.py.
"""
import os
import sys

import pytest
import torch

import gmix_tpu as g
import gmix_tpu_torch as gt
from gmix_tpu_torch import variants
from gmix_tpu_torch.config import reference_spec, scale_tables
from gmix_tpu_torch.core.codec import Predictor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import tpu_ablate  # noqa: E402

torch.set_num_threads(1)

ABLATE_BITS, S = 8, 2
# ~200 bytes, 100 a stream in one chunk of 100: the LSTM's horizon divides it,
# so both packages defer the one backward pass to the end of the segment
N_LSTM, CHUNK_LSTM = 200, 100


@pytest.mark.parametrize("v", ["nomatch", "mixtb0"])
def test_ablate_with_the_lstm_codes_as_jitted_gmix_tpu(v, monkeypatch):
    monkeypatch.setenv("GMIX_ABLATE_BITS", str(ABLATE_BITS))
    t_spec = variants.ablate(scale_tables(reference_spec(), ABLATE_BITS, history_bits=ABLATE_BITS + 4), v)
    j_spec = tpu_ablate.variant(v)
    with open("data/corpus_100k.bin", "rb") as f:
        data = f.read(N_LSTM)
    pred = Predictor(t_spec, S, device="cpu")
    blob = gt.compress_bytes(data, t_spec, S, CHUNK_LSTM, pred=pred)
    assert gt.decompress_bytes(blob, t_spec, CHUNK_LSTM, device="cpu") == data
    jp = g.Predictor(j_spec, S)
    j_blob = g.compress_bytes(data, j_spec, S, CHUNK_LSTM, pred=jp)
    assert abs(len(blob) - len(j_blob)) <= 0.01 * len(j_blob)
    assert abs(gt.entropy_bits(pred) - g.entropy_bits(jp)) <= 0.005 * g.entropy_bits(jp)
    assert blob[:40] == j_blob[:40]  # the same header: container, sizes, spec hash
    assert int(pred.state["stm"]["lstm"]["update_steps"]) == int(jp.state["stm"]["lstm"]["update_steps"]) == 1
