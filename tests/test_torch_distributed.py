"""Streams over processes in the port (`gmix_tpu_torch.parallel.distributed`):
four spawned ranks over `gloo` on the CPU, one torch thread each, code
tiny_spec(True) at 8 streams and must each return the one-process archive
byte for byte (tests/test_multihost.py is gmix_tpu's counterpart)."""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, S, CHUNK, N = 4, 8, 20, 320

RANK_SCRIPT = f"WORLD, S, CHUNK = {WORLD}, {S}, {CHUNK}\n" + r"""
import json, sys
import torch
torch.set_num_threads(1)
rank, port, data_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from gmix_tpu_torch.parallel import distributed as D
D.initialize(f"tcp://localhost:{port}", WORLD, rank, backend="gloo")
import gmix_tpu_torch as gt
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.parallel.mesh import shard_rows
from gmix_tpu_torch.state import init_state
spec = gt.tiny_spec(True)
data = open(data_path, "rb").read()
blob = D.compress_bytes_multihost(data, spec, S, CHUNK, device="cpu")
empty = D.compress_bytes_multihost(b"", spec, S, CHUNK, device="cpu")
mesh = D.global_mesh(device="cpu")
meta = build_meta(spec)
mine, whole = D.make_global_state(meta, S, mesh), init_state(meta, S)
a, b = shard_rows(S, mesh)[rank]
def same(x, y):
    if isinstance(x, dict):
        return sorted(x) == sorted(y) and all(same(x[k], y[k]) for k in x)
    return torch.equal(x, y[a:b] if y.dim() else y)
D.dist.destroy_process_group()
open(f"{out_path}.{rank}.gxtc", "wb").write(blob)
open(f"{out_path}.{rank}.empty", "wb").write(empty)
json.dump({"mesh": [str(d) for d in mesh.devices], "rows": [a, b], "global_state_is_init_rows": same(mine, whole)},
          open(f"{out_path}.{rank}.json", "w"))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's container, empty-input container and record; the ranks
    get 300 s, then every one of them is killed and the test fails."""
    tmp = tmp_path_factory.mktemp("ranks")
    with open("data/corpus_100k.bin", "rb") as f:
        data = f.read(N)
    (tmp / "in.bin").write_bytes(data)
    (tmp / "rank.py").write_text(RANK_SCRIPT)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "rank.py"), str(r), str(port), str(tmp / "in.bin"),
                               str(tmp / "out")], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail("the ranks did not end within 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{err.decode()[-3000:]}"
    return data, [dict(blob=(tmp / f"out.{r}.gxtc").read_bytes(), empty=(tmp / f"out.{r}.empty").read_bytes(),
                       **json.loads((tmp / f"out.{r}.json").read_text())) for r in range(WORLD)]


def test_every_rank_returns_the_one_process_archive(ranks):
    data, out = ranks
    single = gt.compress_bytes(data, gt.tiny_spec(True), S, CHUNK, device="cpu")
    assert all(r["blob"] == single for r in out)


def test_the_container_decodes_through_decompress_bytes(ranks):
    data, out = ranks
    assert gt.decompress_bytes(out[0]["blob"], gt.tiny_spec(True), CHUNK, device="cpu") == data


def test_empty_input_gives_the_one_process_header(ranks):
    _, out = ranks
    assert all(r["empty"] == gt.compress_bytes(b"", gt.tiny_spec(True), S, CHUNK) for r in out)


def test_each_rank_holds_its_block_of_streams(ranks):
    """global_mesh is the ranks' devices in rank order; rank r holds streams
    2r, 2r+1, and make_global_state gives it those rows of init_state."""
    _, out = ranks
    assert all(r["mesh"] == ["cpu"] * WORLD for r in out)
    assert [r["rows"] for r in out] == [[2 * i, 2 * i + 2] for i in range(WORLD)]
    assert all(r["global_state_is_init_rows"] for r in out)


def test_nccl_and_ranks_need_a_cuda_device():
    """Nothing falls back to the CPU: without a CUDA device the nccl backend
    and a rank's default device raise."""
    if torch.cuda.is_available():
        assert distributed.rank_device(torch.cuda.device_count()) == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA device"):
        distributed.initialize("tcp://localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device(0)
    assert distributed.rank_device(3, "cpu") == torch.device("cpu")
