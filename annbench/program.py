"""The system under test: the port, `sptag_tpu_torch`, through its normal
path.  The only module of the benchmark that imports it.

`build` makes the index the way a user does (`create_instance`,
`set_parameter`, `build`) with the configuration's parameters and then
the traffic's, times the build on the host clock, and hands back the
entry the window drives: ``VectorIndex.search_batch(queries, k)``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from annbench.session import Built


def build(config: dict, traffic: dict, corpus: np.ndarray,
          device: torch.device) -> Built:
    import sptag_tpu_torch as sp
    from sptag_tpu_torch.utils.trace import capture_lock

    index = sp.create_instance(config["index_algo"], config["value_type"],
                               device=str(device))
    params = dict(config["index_params"])
    params.update(traffic.get("index_params", {}))
    for name, value in params.items():
        if not index.set_parameter(name, str(value)):
            raise ValueError(f"set_parameter({name!r}, {value!r}) refused")
    t0 = time.perf_counter()
    code = index.build(corpus)
    build_s = time.perf_counter() - t0
    if code != sp.ErrorCode.Success:
        raise RuntimeError(f"build returned {code!r}")
    k = int(config["k"])

    def search(queries: np.ndarray):
        return index.search_batch(queries, k)

    return Built(search=search, build_s=build_s,
                 build_stages=dict(getattr(index, "build_stages", {})),
                 guard=capture_lock)
