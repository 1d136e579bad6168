"""Local index-host server for the in-process AnnIndex facades (the port's
counterpart of ``wrappers/index_host.py``).

The reference's SWIG wrappers run the whole index inside the Java / C#
process.  Here the index core is PyTorch, so a facade OWNS a local child
running this module and drives the whole lifecycle (Build / Add / Search /
Delete / SetSearchParam / Save / Load) over the loopback wire through the
port's SearchServer.  The child is private to its facade: remote admin is
on, persist ops are sandboxed to the directory the facade chose, and it
serves 127.0.0.1 only.

    python -m sptag_tpu_torch.tools.index_host <port_file> [persist_root]
        [--device DEV]

It writes the chosen ephemeral port to <port_file> and serves until
killed.  Indexes live on the CUDA card unless ``--device`` names another
device (``--device cpu``); without CUDA and without ``--device`` it
raises.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys


async def serve(port_file: str, persist_root: str, device) -> None:
    from sptag_tpu_torch.serve.server import SearchServer
    from sptag_tpu_torch.serve.service import ServiceContext, ServiceSettings

    ctx = ServiceContext(ServiceSettings(
        default_max_result=10,
        enable_remote_admin=True,
        admin_persist_root=persist_root,
    ), device=device)
    server = SearchServer(ctx, batch_window_ms=1.0)
    host, port = await server.start("127.0.0.1", 0)
    tmp = f"{port_file}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, port_file)          # the facade never reads half a port
    print(f"index host on {host}:{port}", flush=True)
    await asyncio.Event().wait()        # serve until killed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="index_host",
        description="loopback index host for the AnnIndex facades")
    parser.add_argument("port_file")
    parser.add_argument("persist_root", nargs="?", default="")
    parser.add_argument("--device", default=None,
                        help="torch device of the indexes (default: the "
                             "CUDA card)")
    args = parser.parse_args(argv)
    from sptag_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    asyncio.run(serve(args.port_file, args.persist_root, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
