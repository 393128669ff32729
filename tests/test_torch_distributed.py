"""The port's multi-host join (echo_tts_torch/parallel/distributed.py) on
the CPU: two local processes join a gloo world through
initialize_from_env (ECHO_COORD / ECHO_NUM_PROCS / ECHO_PROC_ID, with
ECHO_DEVICE=cpu), build the global (data, model) mesh with the model axis
inside the host, feed the rows of their data coordinate, and agree on a
data-parallel sum.  Mirrors tests/test_distributed.py; a process here is
one card (or one CPU rank), not one host.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from echo_tts_torch.parallel import distributed as pdist
from echo_tts_torch.parallel import mesh as pmesh

assert pdist.initialize_from_env()
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
rank = dist.get_rank()

tp_mesh = pdist.global_mesh(tp=2)        # both ranks of the one host
assert pmesh.mesh_coords(tp_mesh) == (1, 2, 0, rank)
assert pdist.process_local_batch_slice(8, tp_mesh) == slice(0, 8)
try:
    pdist.global_mesh(tp=4)
    raise AssertionError("tp=4 over 2 ranks of a host was accepted")
except ValueError as exc:
    assert "per-host device count 2" in str(exc)

mesh = pdist.global_mesh()               # tp=1: data parallelism
assert pmesh.mesh_coords(mesh) == (2, 1, rank, 0)
sl = pdist.process_local_batch_slice(8, mesh)
assert sl == pdist.process_local_batch_slice(8) == slice(4 * rank, 4 * rank + 4)
full = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
got = (full[sl] @ torch.ones((16, 4))).sum()
dist.all_reduce(got)
expect = float(full.sum() * 4)
assert abs(float(got) - expect) < 1e-3, (float(got), expect)
dist.destroy_process_group()
print("DIST_OK", float(got))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_world():
    env_base = dict(os.environ, ECHO_COORD=f"127.0.0.1:{_free_port()}",
                    ECHO_NUM_PROCS="2", ECHO_DEVICE="cpu", OMP_NUM_THREADS="1")
    procs = []
    for pid in (0, 1):
        env = dict(env_base, ECHO_PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, REPO], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "DIST_OK" in out


def test_join_is_a_no_op_without_a_coordinator(monkeypatch):
    from echo_tts_torch.parallel import distributed as pdist
    monkeypatch.delenv("ECHO_COORD", raising=False)
    assert pdist.initialize_from_env() is False


def test_card_join_refuses_without_a_card(monkeypatch):
    """The default join is on the card (NCCL); without one it raises
    before touching the network, and never falls back to gloo."""
    import torch
    from echo_tts_torch.parallel import distributed as pdist
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("ECHO_COORD", "127.0.0.1:1")
    monkeypatch.setenv("ECHO_NUM_PROCS", "2")
    monkeypatch.setenv("ECHO_PROC_ID", "0")
    monkeypatch.delenv("ECHO_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        pdist.initialize_from_env()
