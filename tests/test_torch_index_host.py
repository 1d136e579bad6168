"""The port's index host (``python -m sptag_tpu_torch.tools.index_host``),
the child the AnnIndex facades own: spawned for real, its published port
is driven through the facade op sequence over the socket (build with
metadata, search, setparam, save, load), then it is killed — the
lifecycle tests/test_serve.py ``test_index_host_child_lifecycle`` drives
against wrappers/index_host.py.
"""

import base64
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from sptag_tpu_torch.serve.client import AnnClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(port_file, persist, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "sptag_tpu_torch.tools.index_host",
         str(port_file), str(persist), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_index_host_child_lifecycle(tmp_path):
    port_file = tmp_path / "port"
    persist = tmp_path / "persist"
    proc = _spawn(port_file, persist, "--device", "cpu")
    try:
        port = None
        for _ in range(600):
            if proc.poll() is not None:
                raise AssertionError(
                    "host died: " + proc.stdout.read().decode())
            if port_file.exists() and port_file.read_text().strip():
                port = int(port_file.read_text())
                break
            time.sleep(0.2)
        assert port is not None, "host never published its port"
        cli = AnnClient("127.0.0.1", port, timeout_s=60.0)
        cli.connect()
        rows = np.arange(32, dtype=np.float32)
        metas = base64.b64encode(
            b"\x00".join(f"m{r}".encode() for r in range(8))).decode()
        blk = base64.b64encode(rows.tobytes()).decode()
        r = cli.search("$admin:build $indexname:idx $datatype:Float "
                       f"$dimension:4 $algo:FLAT $metadata:{metas} "
                       f"$withmetaindex:1 #{blk}")
        assert r.results[0].index_name == "admin:ok:built"
        q = base64.b64encode(
            np.asarray([4, 5, 6, 7], np.float32).tobytes()).decode()
        r = cli.search(f"$indexname:idx $extractmetadata:true #{q}")
        assert r.results[0].ids[0] == 1
        assert r.results[0].metas[0] == b"m1"
        assert cli.search("$admin:setparam $indexname:idx "
                          "$params:SketchPrefilter=true"
                          ).results[0].index_name == "admin:ok:set"
        p64 = base64.b64encode(b"snap").decode()
        assert cli.search(f"$admin:save $indexname:idx $path:{p64}"
                          ).results[0].index_name == "admin:ok:saved"
        assert (persist / "snap").is_dir()
        assert cli.search(f"$admin:load $indexname:idx $path:{p64}"
                          ).results[0].index_name == "admin:ok:loaded"
        r = cli.search(f"$indexname:idx #{q}")
        assert r.results[0].ids[0] == 1
        cli.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_index_host_needs_the_card_unless_told(tmp_path, monkeypatch):
    import torch

    from sptag_tpu_torch.tools import index_host

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index_host.main([str(tmp_path / "port")])
