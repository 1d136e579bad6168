"""Multi-process mesh of the port (sptag_tpu_torch/parallel/multihost.py):
two real OS processes over gloo on the CPU, each building 2 of 4 shards,
return the ids and distances of a one-process 4-shard mesh over the same
rows (beam and dense), mirroring tests/test_multihost.py.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sptag_tpu_torch.parallel import sharded as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"TPTNumber": 2, "CEF": 32, "MaxCheckForRefineGraph": 64,
          "NeighborhoodSize": 8, "FinalRefineSearchMode": "same",
          "MaxCheck": 128, "BKTKmeansK": 4, "RefineIterations": 1}

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    params = eval(sys.argv[4])
    from sptag_tpu_torch.parallel import multihost
    from sptag_tpu_torch.parallel.sharded import Mesh
    multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                         process_id=rank)
    rng = np.random.default_rng(0)
    data = rng.integers(-8, 9, (1000, 8)).astype(np.float32)
    queries = np.random.default_rng(1).integers(-8, 9, (16, 8)).astype(
        np.float32)
    n_local = 250
    idx = multihost.build_process_sharded(
        lambda s: data[s * n_local:(s + 1) * n_local], 1000, 8, 0,
        mesh=Mesh(["cpu", "cpu"]), params=params, dense=True)
    d, i = idx.search(queries, 10)
    dd, di = idx.search_dense(queries, 10, max_check=128)
    np.savez(out, d=d, i=i, dd=dd, di=di, base=idx._shard_base,
             shards=idx.n_shards)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_equal_the_one_process_mesh(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port),
         str(tmp_path / f"r{r}.npz"), repr(PARAMS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    assert (int(r0["base"]), int(r1["base"])) == (0, 2)
    assert int(r0["shards"]) == int(r1["shards"]) == 4
    for key in ("d", "i", "dd", "di"):         # every process merges alike
        np.testing.assert_array_equal(r0[key], r1[key])

    torch.set_num_threads(1)
    data = np.random.default_rng(0).integers(-8, 9, (1000, 8)).astype(
        np.float32)
    queries = np.random.default_rng(1).integers(-8, 9, (16, 8)).astype(
        np.float32)
    one = ts.ShardedBKTIndex.build(data, 0, mesh=ts.Mesh(["cpu"] * 4),
                                   params=PARAMS, dense=True)
    d, i = one.search(queries, 10)
    np.testing.assert_array_equal(r0["i"], i)
    np.testing.assert_array_equal(r0["d"], d)
    dd, di = one.search_dense(queries, 10, max_check=128)
    np.testing.assert_array_equal(r0["di"], di)
    np.testing.assert_array_equal(r0["dd"], dd)
    assert (i[:, 0] >= 0).all()


def test_initialize_is_a_no_op_alone_and_needs_an_address(monkeypatch):
    from sptag_tpu_torch.parallel import multihost

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()                    # one process: nothing to do
    import torch.distributed as dist
    assert not dist.is_initialized()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize()
    with pytest.raises(ValueError, match="BKT or KDT"):
        multihost.build_process_sharded(lambda s: None, 10, 2,
                                        mesh=ts.Mesh(["cpu"]), algo="FLAT")
