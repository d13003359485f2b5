"""Multi-process sharding in the torch port (`parallel/multihost.py`):
two real processes join one gloo group through the GOL_COORDINATOR
contract and run every sharded path over an 8-shard mesh whose ring
crosses the process boundary (`tests/torch_multihost_worker.py`, four
CPU devices each). The assembled shards equal the one-process run and
`gol_tpu`'s; two `python -m gol_tpu_torch.server --coordinator` processes
join one group and serve. Tolerance: none."""

import importlib.util
import os
import re
import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.models.generations import BRIANS_BRAIN as J_BRIAN
from gol_tpu.models.generations import run_turns as jgen_run
from gol_tpu.ops.reference import run_turns_np as jrun_np

from gol_tpu_torch.ops.bitpack import pack_np
from gol_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_module(repo_root):
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_worker",
        repo_root / "tests" / "torch_multihost_worker.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(repo_root):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo_root) + os.pathsep + env.get(
        "PYTHONPATH", "")
    for k in ("GOL_COORDINATOR", "GOL_NUM_PROCS", "GOL_PROC_ID", "SER"):
        env.pop(k, None)
    return env


@pytest.mark.timeout(240)
def test_two_process_mesh_equals_one_process_and_gol_tpu(repo_root,
                                                         tmp_path):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u",
         str(repo_root / "tests" / "torch_multihost_worker.py"), str(port),
         str(rank), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(repo_root), cwd=str(repo_root)) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=200)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank}:\n{out[-3000:]}"
        assert f"TORCH_MULTIHOST_OK proc {rank}" in out
    saved = {}
    for rank in (0, 1):
        with np.load(tmp_path / f"proc{rank}.npz") as z:
            saved.update({k: z[k] for k in z.files})
    worker = _worker_module(repo_root)
    mesh = make_mesh(8, [torch.device("cpu")] * 8)
    for name, (h, w, turns, repr_) in worker.CASES.items():
        got = np.concatenate([saved[f"{name}_{pos}"] for pos in range(8)],
                             axis=-2)
        one, counts = worker.run_case(name, mesh, worker.boards(name))
        np.testing.assert_array_equal(got, one.gather().numpy(), name)
        board = worker.boards(name)
        if repr_ in ("packed", "u8"):
            want = jrun_np(board, turns)
            np.testing.assert_array_equal(
                got.view(np.uint32)[:h] if repr_ == "packed" else got,
                pack_np(want) if repr_ == "packed" else want, name)
        else:
            want = np.asarray(jgen_run(jnp.asarray(board), turns, J_BRIAN))
            if repr_ == "gen3":
                state = (np.unpackbits(got[0].view(np.uint32).view(np.uint8),
                                       bitorder="little").reshape(h, w)
                         + 2 * np.unpackbits(
                             got[1].view(np.uint32).view(np.uint8),
                             bitorder="little").reshape(h, w))
                np.testing.assert_array_equal(state, want, name)
            else:
                np.testing.assert_array_equal(got, want, name)
        if counts is not None:
            total = sum(int(saved[f"{name}_count_{pos}"][0])
                        for pos in range(8))
            assert total == sum(int(c) for c in counts), name
            assert total == int(((want == 1) if repr_ == "gen3"
                                 else want).sum()), name


@pytest.mark.timeout(240)
def test_server_coordinator_joins_one_group(repo_root):
    """Two `python -m gol_tpu_torch.server --coordinator` processes (one
    CPU device each) join one gloo group before their engines exist,
    report the group's two devices beside the one device each engine
    serves, and serve."""
    coord = _free_port()
    procs = []
    for rank in (0, 1):
        env = _env(repo_root)
        env.update(GOL_NUM_PROCS="2", GOL_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-m", "gol_tpu_torch.server", "--port",
             "0", "--host", "127.0.0.1", "--device", "cpu",
             "--coordinator", f"127.0.0.1:{coord}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(repo_root)))
    results = {}

    def scan(i, p):
        seen = None
        for line in p.stdout:
            m = re.search(r"multi-process group: process (\d)/2, (\d+) "
                          r"device\(s\), backend (\w+); this engine "
                          r"serves its own (\d+) device", line)
            if m:
                seen = (int(m.group(1)), int(m.group(2)), m.group(3),
                        int(m.group(4)))
            if "serving on" in line:
                results[i] = seen
                return

    threads = [threading.Thread(target=scan, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(200)
        assert results == {0: (0, 2, "gloo", 1),
                           1: (1, 2, "gloo", 1)}, results
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


CPU, CUDA0, CUDA1 = (torch.device("cpu"), torch.device("cuda", 0),
                     torch.device("cuda", 1))


@pytest.mark.parametrize("placed,want", [
    # CPU shards: gloo, whatever else the group holds.
    ([(0, CPU, None), (1, CPU, None)], "gloo"),
    ([(0, CUDA0, "card-a"), (1, CPU, None)], "gloo"),
    # Two ranks on one card (chip_smoke's two processes on cuda:0).
    ([(0, CUDA0, "card-a"), (0, CUDA0, "card-a"), (1, CUDA0, "card-a"),
      (1, CUDA0, "card-a")], "gloo"),
    # One rank over two cards.
    ([(0, CUDA0, "card-a"), (0, CUDA1, "card-b"), (1, CUDA0, "card-c")],
     "gloo"),
    # Distinct cards, one a rank (shards may repeat on their card).
    ([(0, CUDA0, "card-a"), (1, CUDA0, "card-b")], "nccl"),
    ([(0, CUDA0, "card-a"), (0, CUDA0, "card-a"), (1, CUDA1, "card-b"),
      (1, CUDA1, "card-b")], "nccl"),
])
def test_halo_backend_follows_the_shards_devices(placed, want):
    """The halos' backend is chosen from the devices the shards sit on:
    NCCL only for CUDA shards, one card a rank and no card shared by
    two ranks; gloo (CUDA halos staged through host memory) otherwise."""
    from gol_tpu_torch.parallel import multihost

    assert multihost.halo_backend(placed) == want
