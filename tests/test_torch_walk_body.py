"""The exact walk body's glue (ops/walk_body.py, csrc/walk_body.cu).

On the CPU the body runs the plain versions: they must give the state the
port's PyTorch body gave before the kernels (a copy of that body below is
the oracle), the wrappers must refuse what the kernels do not take, and
the beam must stay sorted by (distance, position) after seeding and after
every merge, which the kernels' prefix pop relies on.  On the card
(marker ``cuda``; this file imports neither jax nor sptag_tpu, so on the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_walk_body.py``)
the kernels must give every state tensor of the plain body bit for bit
after every body, eager and replayed from a captured graph, and the
resident kernel (all of a captured walk's bodies in one launch) the state
of as many three-launch bodies.  The corpus is integer-valued, so
distances tie often; the resident kernel's card tests also walk the
single-query cell's plan on float rows.
"""

import numpy as np
import pytest
import torch

from sptag_tpu_torch.algo import engine as teng
from sptag_tpu_torch.algo.dense import _sorted_dup_mask
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import walk_body as wb

MAX = teng.MAX_DIST


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_walk_body.py)")
    return torch.device("cuda")


# the cases: rows n, degree m, width D, queries Q, k, L, B, nbp limit,
# spares injected at once, bodies T, share of -1 graph slots, repeated
# rows, pivots, seeded (KDT) or not
CASES = {
    "cell_plan": dict(n=4000, m=32, D=16, Q=6, k=10, L=320, B=64, nbp=3,
                      inject=4, T=10, pad=0.05, dup=0, piv=400),
    "no_spares": dict(n=1500, m=16, D=8, Q=5, k=10, L=100, B=16, nbp=3,
                      inject=0, T=10, pad=0.1, dup=0, piv=300),
    "kdt_seeded": dict(n=1500, m=16, D=8, Q=5, k=10, L=96, B=24, nbp=3,
                       inject=4, T=10, pad=0.1, dup=0, piv=0),
    "ties": dict(n=1200, m=12, D=3, Q=6, k=20, L=90, B=20, nbp=3, inject=4,
                 T=12, pad=0.1, dup=500, piv=200),
    "padded_graph": dict(n=1000, m=16, D=6, Q=5, k=10, L=64, B=16, nbp=3,
                         inject=4, T=10, pad=0.6, dup=0, piv=100),
    "nbp_tripped": dict(n=1000, m=8, D=6, Q=5, k=5, L=48, B=8, nbp=1,
                        inject=2, T=14, pad=0.2, dup=200, piv=40),
    "few_unexpanded": dict(n=150, m=8, D=4, Q=5, k=10, L=140, B=32, nbp=3,
                           inject=4, T=10, pad=0.3, dup=30, piv=40),
    "odd_sizes": dict(n=3000, m=33, D=5, Q=4, k=10, L=77, B=63, nbp=2,
                      inject=4, T=8, pad=0.05, dup=0, piv=300),
}


def _engine(c, dev, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(-4, 5, (c["n"], c["D"])).astype(np.float32)
    if c["dup"]:
        data[-c["dup"]:] = data[:c["dup"]]
    graph = rng.integers(0, c["n"], (c["n"], c["m"])).astype(np.int32)
    graph[rng.random(graph.shape) < c["pad"]] = -1
    piv = rng.choice(c["n"], max(c["piv"], 1), replace=False)
    eng = teng.GraphSearchEngine(data, graph, piv, None, DistCalcMethod.L2,
                                 1, device=dev)
    q = rng.integers(-4, 5, (c["Q"], c["D"])).astype(np.float32)
    q[1] = q[0]                                       # a repeated query
    q = torch.from_numpy(q).to(dev)
    seeds = None
    if not c["piv"]:
        s = rng.integers(-1, c["n"], (c["Q"], 40))
        s[:, 1] = s[:, 0]                             # a repeated seed
        seeds = torch.from_numpy(s).to(dev)
    state = eng.seed_state(q, c["L"], seeds=seeds)
    t_limit = torch.full((c["Q"],), c["T"], dtype=torch.int64, device=dev)
    t_limit[-1] = 0                                   # a pad row
    t_limit[-2] = 3                                   # a short budget
    return eng, state, t_limit


def _walk(eng, state, t_limit, c, fused):
    w = teng._Walk(eng, state, t_limit, c["k"], c["L"], c["B"], c["nbp"],
                   c["inject"] if state.get("spare_ids") is not None else 0,
                   0)
    if not fused:
        w.fused = False
    return w


def _clone(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def _assert_same(got, want, where):
    for key in teng.STATE_KEYS:
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape, (where, key)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (where, key)


def _scheduler_edit(step, state, L, donor):
    """What the slot scheduler does between segments: blank a slot (the
    empty-row encoding), then insert a freshly seeded row into it."""
    if step == 1:
        state["cand_ids"][0] = -1
        state["cand_d"][0] = MAX
        state["expanded"][0] = True
        state["expanded"][0, L] = False
        state["visited"][0] = False
        for key in ("no_better", "ptr", "it"):
            state[key][0] = 0
        if state.get("spare_ids") is not None:
            state["spare_ids"][0] = -1
            state["spare_d"][0] = MAX
    elif step == 3:
        for key, v in donor.items():
            if isinstance(v, torch.Tensor) and key != "queries":
                state[key][0] = v[1]


# ---- the oracle: the port's exact body before the kernels -------------------

def _former_body(w):
    """The exact body as algo/engine.py ran it before ops/walk_body.py
    (pop by a stable sort, the neighbours' `flat` ids in the merge)."""
    eng, L, B, N = w.eng, w.L, w.B, w.eng.n
    Q = w.queries.shape[0]
    act = w.no_better < w.nbp_limit
    if w.use_spares:
        act = act | (w.ptr < w.n_spare)
    active = act & (w.it < w.t_limit)
    sel_score = torch.where(w.expanded[:, :L], MAX, w.cand_d)
    sel_d, spos = dist_ops.smallest_k(sel_score, B)
    sel_ok = (sel_d < MAX) & active[:, None]
    best_pop_d = sel_d[:, 0]
    sel_ids = torch.where(sel_ok, torch.gather(w.cand_ids, 1, spos), -1)
    w.expanded.scatter_(1, torch.where(sel_ok, spos, L), True)
    frontier_worse = best_pop_d > w.cand_d[:, w.k_eff - 1]
    nbrs = eng.graph[sel_ids.clamp_min(0)].to(torch.int64)
    flat = torch.where(sel_ok[..., None], nbrs, -1).reshape(Q, -1)
    flat_safe = torch.where(flat >= 0, flat, N)
    seen = torch.gather(w.visited, 1, flat_safe)
    fresh = (flat >= 0) & ~seen & ~_sorted_dup_mask(flat_safe)
    w.visited.scatter_(1, flat_safe, True)
    nd = w._score(sel_ids, torch.where(fresh, flat, -1))
    trigger = None
    if w.use_spares:
        Ps, ptr = w.Ps, w.ptr
        next_d = torch.gather(w.spare_d, 1,
                              ptr.clamp_max(Ps - 1)[:, None])[:, 0]
        stalled = w.no_better + 1 >= w.nbp_limit
        trigger = active & (ptr < w.n_spare) & ((best_pop_d > next_d)
                                                | stalled)
        idxs = ptr[:, None] + torch.arange(w.inject)[None, :]
        ok = trigger[:, None] & (idxs < Ps)
        safe = idxs.clamp_max(Ps - 1)
        inj_ids = torch.where(ok, torch.gather(w.spare_ids, 1, safe), -1)
        inj_d = torch.where(ok & (inj_ids >= 0),
                            torch.gather(w.spare_d, 1, safe), MAX)
        w.ptr = torch.where(trigger, ptr + w.inject, ptr)
        nd = torch.cat([nd, inj_d], dim=1)
        flat = torch.cat([flat, inj_ids], dim=1)
    all_d = torch.cat([w.cand_d, nd], dim=1)
    all_ids = torch.cat([w.cand_ids, flat], dim=1)
    all_exp = torch.cat([w.expanded[:, :L],
                         torch.zeros((Q, all_d.shape[1] - L),
                                     dtype=torch.bool)], dim=1)
    cand_d, mpos = dist_ops.smallest_k(all_d, L)
    w.cand_d = cand_d
    w.cand_ids = torch.where(cand_d < MAX, torch.gather(all_ids, 1, mpos),
                             -1)
    w.expanded = torch.cat([torch.gather(all_exp, 1, mpos),
                            torch.zeros((Q, 1), dtype=torch.bool)], dim=1)
    nb = torch.where(active, torch.where(frontier_worse, w.no_better + 1, 0),
                     w.no_better)
    if trigger is not None:
        nb = torch.where(trigger, 0, nb)
    w.no_better = nb
    w.it = w.it + 1


def _sorted_rows(d):
    """Each row ascending in torch.sort's order (NaN last)."""
    return torch.equal(torch.sort(d, dim=1, stable=True)[0].view(torch.int32),
                       d.contiguous().view(torch.int32))


def _prefix_pop(cand_d, expanded, B):
    """The kernels' pop: the first B positions not expanded and below MAX."""
    L = cand_d.shape[1]
    out = []
    for d, e in zip(cand_d, expanded[:, :L]):
        elig = ((~e) & (d < MAX)).nonzero()[:, 0]
        out.append(elig[:B].tolist())
    return out


# ---- CPU --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cell_plan", "kdt_seeded", "ties",
                                  "few_unexpanded", "odd_sizes"])
def test_plain_body_gives_the_former_body_and_keeps_the_beam_sorted(case):
    c = CASES[case]
    eng, state, t_limit = _engine(c, "cpu")
    assert _sorted_rows(state["cand_d"])
    donor = eng.seed_state(state["queries"].flip(0), c["L"])
    old, new = _clone(state), _clone(state)
    for step in range(c["T"]):
        w_old = _walk(eng, old, t_limit, c, fused=False)
        w_new = _walk(eng, new, t_limit, c, fused=False)
        assert not w_new.fused
        # the prefix pop the kernels run picks what the stable sort picks
        want = [r[:c["B"]] for r in _prefix_pop(w_new.cand_d,
                                                w_new.expanded, c["B"])]
        sel_score = torch.where(w_new.expanded[:, :c["L"]], MAX,
                                w_new.cand_d)
        sel_d, spos = dist_ops.smallest_k(sel_score, c["B"])
        for row, picks in enumerate(want):
            n_ok = int((sel_d[row] < MAX).sum())
            assert spos[row, :n_ok].tolist() == picks
        _former_body(w_old)
        w_new.body()
        old, new = w_old.state(), w_new.state()
        _assert_same(new, old, f"{case} body {step}")
        assert _sorted_rows(new["cand_d"])
        if case == "cell_plan":
            _scheduler_edit(step, old, c["L"], donor)
            _scheduler_edit(step, new, c["L"], donor)
            assert _sorted_rows(new["cand_d"])


def test_wrappers_run_the_plain_versions_on_the_cpu():
    c = CASES["cell_plan"]
    eng, state, t_limit = _engine(c, "cpu")
    before = wb.launch_counts()
    assert set(before) == set(wb.KERNELS)
    ref, got = _clone(state), _clone(state)
    w = _walk(eng, ref, t_limit, c, fused=False)
    w.body()
    g = _walk(eng, got, t_limit, c, fused=False)
    sel_ids, fresh_ids, ctl = wb.walk_pop_expand(
        g.cand_ids, g.cand_d, g.expanded, g.visited, g.no_better, g.ptr,
        g.it, g.t_limit, g.n_spare, eng.graph, g.k_eff, g.B, g.nbp_limit)
    assert fresh_ids.shape == (c["Q"], c["B"] * c["m"])
    nd = g._score(sel_ids, fresh_ids)
    out = wb.walk_merge(g.cand_ids, g.cand_d, g.expanded, nd, fresh_ids,
                        ctl, g.no_better, g.ptr, g.it, g.n_spare,
                        g.spare_ids, g.spare_d, g.inject, g.nbp_limit)
    got.update(zip(("cand_ids", "cand_d", "expanded", "no_better", "ptr",
                    "it"), out))
    _assert_same(got, w.state(), "wrappers")
    assert wb.launch_counts() == before


def _meta_state(Q=2, L=8, N=20, m=4, B=2):
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return dict(cand_ids=t((Q, L), torch.int64),
                cand_d=t((Q, L), torch.float32),
                expanded=t((Q, L + 1), torch.bool),
                visited=t((Q, N + 1), torch.bool),
                no_better=t((Q,), torch.int64), ptr=t((Q,), torch.int64),
                it=t((Q,), torch.int64), t_limit=t((Q,), torch.int64),
                n_spare=None, graph=t((N, m), torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "contiguous",
                                 "plan"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    s = _meta_state()
    k_eff, B = 2, 2
    if bad == "dtype":
        s["cand_d"] = s["cand_d"].to(torch.float64)
    elif bad == "shape":
        s["visited"] = torch.empty((2, 20), dtype=torch.bool, device="meta")
    elif bad == "device":
        s["graph"] = torch.empty((20, 4), dtype=torch.int32)
    elif bad == "contiguous":
        s["expanded"] = torch.empty((9, 2), dtype=torch.bool,
                                    device="meta").T
    else:
        B = 9                                          # more pops than L
    with pytest.raises((TypeError, ValueError)):
        wb.walk_pop_expand(*s.values(), k_eff, B, 3)
    m = _meta_state()
    nd = torch.empty((2, 8), dtype=torch.float32, device="meta")
    fresh = torch.empty((2, 8), dtype=torch.int64, device="meta")
    ctl = torch.empty((2, 3), dtype=torch.int32, device="meta")
    args = [m["cand_ids"], m["cand_d"], m["expanded"], nd, fresh, ctl,
            m["no_better"], m["ptr"], m["it"], None, None, None, 4, 3]
    if bad == "dtype":
        args[3] = nd.to(torch.float64)
    elif bad == "shape":
        args[5] = torch.empty((2, 2), dtype=torch.int32, device="meta")
    elif bad == "device":
        args[4] = torch.empty((2, 8), dtype=torch.int64)
    elif bad == "contiguous":
        args[3] = torch.empty((8, 2), dtype=torch.float32, device="meta").T
    else:
        # spares whose queue is empty
        args[9:12] = [m["no_better"],
                      torch.empty((2, 0), dtype=torch.int64, device="meta"),
                      torch.empty((2, 0), dtype=torch.float32,
                                  device="meta")]
    with pytest.raises((TypeError, ValueError)):
        wb.walk_merge(*args)


def test_work_area_and_the_engine_choice():
    # the benchmark's plan: both kernels' areas in shared memory
    assert wb.pop_expand_smem(320, 64, 32) == 4 * (2 * 4096 + 2048 + 128)
    assert wb.merge_smem(320, 2048, 4) == 8 * (2 * 320 + 2 * 4096) + 320
    assert wb.work_area(wb.merge_smem(320, 2048, 4), 6, "meta") == \
        (None, 0, wb.merge_smem(320, 2048, 4))
    # a plan too wide for a CTA: a 16-byte-aligned device area a row
    n = wb.pop_expand_smem(1024, 128, 256)
    assert n > wb.MAX_SMEM
    scratch, row, smem = wb.work_area(n, 6, "meta")
    assert smem == 0 and row % 16 == 0 and 0 <= row - n < 16
    assert scratch.shape == (6 * row,) and scratch.dtype == torch.uint8
    assert not teng.GraphSearchEngine.fused_body("cpu", 0)
    assert teng.GraphSearchEngine.fused_body("cuda", 0)
    assert not teng.GraphSearchEngine.fused_body("cuda", 128)   # binned


# (L, B, m, spares injected at once, N, D): the single-query cell's plan
# (BKT, KDT), a wide beam, odd widths, and corpora past the bitset's room
RESIDENT_PLANS = {
    "cell_bkt": (320, 64, 32, 4, 90_000, 100),
    "cell_kdt": (320, 64, 32, 0, 90_000, 100),
    "wide_beam": (1024, 128, 64, 4, 200_000, 128),
    "odd": (77, 63, 33, 4, 2_999, 5),
    "corpus_1m": (320, 64, 32, 4, 1_000_000, 128),
    "corpus_2m": (320, 64, 32, 4, 2_000_000, 100),
}


# the cell's plan (BKT) part by part, in bytes
CELL_LAYOUT = {"query": 512, "misc": 256, "beam0": 5_440, "beam1": 5_440,
               "hash": 33_280, "slots": 8_192, "pops": 512, "fresh": 24_576,
               "rounds": 256, "spares": 48, "bits": 11_264}


@pytest.mark.parametrize("plan", list(RESIDENT_PLANS))
def test_resident_rule_and_its_shared_memory(plan):
    L, B, m, inject, N, D = RESIDENT_PLANS[plan]
    n = wb.resident_smem(L, B, m, inject, N, D)
    parts = wb.resident_layout(L, B, m, inject, N, D)
    assert n == sum(parts.values()) and n % 16 == 0
    assert all(v % 16 == 0 for v in parts.values())
    # one bit a column of the N + 1, 17 bytes a beam entry, 12 a slot
    assert parts["bits"] == -(-(N + 1) // 128) * 16
    assert parts["beam0"] == parts["beam1"] == -(-17 * L // 16) * 16
    assert parts["fresh"] == -(-12 * B * m // 16) * 16
    if plan == "cell_bkt":
        # the hash table holds the merge's two candidate buffers
        assert parts == CELL_LAYOUT and n == 89_776
    fits = n <= wb.MAX_SMEM
    assert fits == (plan not in ("wide_beam", "corpus_2m"))
    # one bit a corpus row: 128 more rows are 16 more bytes
    assert wb.resident_smem(L, B, m, inject, N + 128, D) == n + 16
    assert wb.resident_walk("cuda", 0, True, L, B, m, inject, N, D) == fits
    assert not wb.resident_walk("cpu", 0, True, L, B, m, inject, N, D)
    assert not wb.resident_walk("cuda", 512, True, L, B, m, inject, N, D)
    assert not wb.resident_walk("cuda", 0, False, L, B, m, inject, N, D)


@pytest.mark.parametrize("Q, sms, want", [(1, 132, 8), (8, 132, 8),
                                          (9, 132, 4), (16, 132, 4),
                                          (17, 132, 2), (33, 132, 2),
                                          (34, 132, 1), (256, 132, 1)])
def test_resident_cluster_rule(Q, sms, want):
    assert wb.cluster_for(Q, sms) == want


@pytest.mark.parametrize("case", list(CASES))
def test_resident_plain_version_gives_the_plain_bodies(case):
    """walk_resident on CPU tensors is T plain bodies: the state of the
    walk's own plain body after T bodies, the input state untouched but for
    `visited`; the engine takes it in run_all where `resident` is set."""
    c = CASES[case]
    eng, state, t_limit = _engine(c, "cpu")
    want = _walk(eng, _clone(state), t_limit, c, fused=False)
    assert not want.resident                  # never on the CPU
    want.run_all(c["T"])
    w = _walk(eng, _clone(state), t_limit, c, fused=False)
    before = _clone(w.state())
    spares = ((w.n_spare, w.spare_ids, w.spare_d) if w.use_spares
              else (None, None, None))
    out = wb.walk_resident(
        w.queries_s, eng.score_src, eng.sqnorm, eng.metric, eng.base,
        w.cand_ids, w.cand_d, w.expanded, w.visited, w.no_better, w.ptr,
        w.it, w.t_limit, *spares, eng.graph, w.k_eff, w.B, w.nbp_limit,
        w.inject, c["T"])
    got = dict(zip(("cand_ids", "cand_d", "expanded", "no_better", "ptr",
                    "it"), out), visited=w.visited)
    _assert_same(got, want.state(), f"{case} walk_resident")
    for key in teng.STATE_KEYS:
        if key != "visited":
            assert torch.equal(getattr(w, key), before[key]), key
    # the engine's run_all through the resident branch
    r = _walk(eng, _clone(state), t_limit, c, fused=False)
    r.resident = True
    assert r.run_all(c["T"]) == c["T"]
    _assert_same(r.state(), want.state(), f"{case} run_all resident")


@pytest.mark.parametrize("binned", ["off", "on"])
def test_fused_body_counter_is_zero_on_the_cpu(binned):
    import sptag_tpu_torch as tsp
    from sptag_tpu_torch.utils import metrics

    rng = np.random.default_rng(3)
    data = rng.integers(-8, 9, (800, 8)).astype(np.float32)
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "128"),
                        ("FinalRefineSearchMode", "same"),
                        ("BinnedTopK", binned)]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    try:
        bodies = metrics.counter_value("search.walk_bodies")
        fused = metrics.counter_value("search.walk_fused_bodies")
        resident = metrics.counter_value("search.walk_resident_bodies")
        idx.search_batch(data[:4] + 0.5, 5, search_mode="beam")
        assert metrics.counter_value("search.walk_bodies") > bodies
        assert metrics.counter_value("search.walk_fused_bodies") == fused
        assert metrics.counter_value("search.walk_resident_bodies") \
            == resident
        assert idx._get_engine().last_fused_iterations == 0
        assert idx._get_engine().last_resident_iterations == 0
    finally:
        idx.close()


# ---- the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("case", list(CASES) + ["scheduler_edits",
                                                "scratch_area"])
def test_fused_body_equals_the_plain_body_on_card(cuda, monkeypatch, case,
                                                  captured):
    c = CASES[case if case in CASES else "cell_plan"]
    if case == "scratch_area":
        # the work areas of a plan too wide for shared memory
        monkeypatch.setattr(wb, "MAX_SMEM", 0)
    eng, state, t_limit = _engine(c, cuda)
    donor = eng.seed_state(state["queries"].flip(0), c["L"]) \
        if case == "scheduler_edits" and c["piv"] else None
    wb.reset_launch_counts()
    plain = _clone(state)
    fused = _clone(state)
    if captured:
        inject = c["inject"] if state.get("spare_ids") is not None else 0
        graph, bufs, t_in, _ = eng.capture_segment(
            fused, t_limit, c["k"], c["L"], c["B"], c["nbp"], 1, inject)
        # the capture's warm-up ran one body on the buffers: start over
        for key, v in fused.items():
            if v is not None:
                bufs[key].copy_(v)
        t_in.copy_(t_limit)
    for step in range(c["T"]):
        w = _walk(eng, plain, t_limit, c, fused=False)
        assert not w.fused
        w.body()
        plain = w.state()
        if captured:
            graph.replay()
            got = bufs
        else:
            w = _walk(eng, fused, t_limit, c, fused=True)
            assert w.fused
            w.body()
            fused = got = w.state()
        torch.cuda.synchronize()
        _assert_same(got, plain, f"{case} body {step}")
        if donor is not None:
            _scheduler_edit(step, plain, c["L"], donor)
            _scheduler_edit(step, got, c["L"], donor)
    launches = wb.launch_counts()
    # eager: one launch of each body kernel a body; captured: the warm-up
    # and the capture, of the resident kernel where its rule allows
    resident = captured and _walk(eng, _clone(state), t_limit, c,
                                  fused=True).resident
    assert resident == (captured and case != "scratch_area")
    want = {**dict.fromkeys(wb.BODY_KERNELS,
                            0 if resident else 2 if captured else c["T"]),
            "walk_resident": 2 if resident else 0}
    assert launches == want


@pytest.mark.cuda
def test_fused_walk_search_on_card_counts_fused_bodies(cuda):
    """An exact beam search on the card runs every body fused (and the
    CPU's answers); a binned one runs none.  A batch past the graph
    buckets walks eagerly and runs no resident body; a single query
    replayed from its captured walk runs every body resident."""
    import sptag_tpu_torch as tsp
    from sptag_tpu_torch.utils import metrics

    rng = np.random.default_rng(11)
    data = rng.integers(-8, 9, (4000, 16)).astype(np.float32)
    q = data[:300] + 0.5
    idx = tsp.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "128"),
                        ("FinalRefineSearchMode", "same")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    try:
        def counted(queries):
            names = ("search.walk_bodies", "search.walk_fused_bodies",
                     "search.walk_resident_bodies")
            before = [metrics.counter_value(n) for n in names]
            idx.search_batch(queries, 10, search_mode="beam")
            return [metrics.counter_value(n) - b
                    for n, b in zip(names, before)]

        for binned in ("off", "on"):
            idx.set_parameter("BinnedTopK", binned)
            d_bodies, d_fused, d_resident = counted(q)
            assert d_bodies > 0
            assert d_fused == (d_bodies if binned == "off" else 0)
            assert d_resident == 0
        idx.set_parameter("BinnedTopK", "off")
        counted(q[:1])                    # seen once: walked eagerly
        for _ in range(2):                # captured, then replayed
            d_bodies, d_fused, d_resident = counted(q[:1])
            assert d_bodies > 0 and d_resident == d_fused == d_bodies
    finally:
        idx.close()


# ---- the resident walk on the card ------------------------------------------

_CELL = dict(n=90_000, m=32, D=100, k=10, L=320, B=64, nbp=3, inject=4,
             T=32)


@pytest.fixture(scope="module")
def cell_engine():
    """An engine at the single-query cell's widths: 90,000 x 100 float
    rows in blobs, a random 32-wide graph with some -1 slots, 8,192
    pivots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_walk_body.py)")
    rng = np.random.default_rng(20)
    c = _CELL
    centres = rng.normal(0, 4, (1000, c["D"]))
    data = (centres[rng.integers(0, 1000, c["n"])]
            + rng.normal(0, 1, (c["n"], c["D"]))).astype(np.float32)
    graph = rng.integers(0, c["n"], (c["n"], c["m"])).astype(np.int32)
    graph[rng.random(graph.shape) < 0.03] = -1
    piv = rng.choice(c["n"], 8192, replace=False)
    eng = teng.GraphSearchEngine(data, graph, piv, None, DistCalcMethod.L2,
                                 1, device="cuda")
    return eng, data, rng


def _cell_state(eng, data, rng, Q, seeded):
    """Q rows: queries near the corpus, the last two rows copies of the
    first (a replay's padding), a row dead at the start (t_limit 0) and
    mixed budgets; KDT-like per-query seeds when `seeded`."""
    c = _CELL
    q = data[rng.integers(0, c["n"], Q)] + rng.normal(0, 0.5, (Q, c["D"]))
    if Q > 2:
        q[-2:] = q[0]
    q = torch.from_numpy(q.astype(np.float32)).to("cuda")
    seeds = None
    if seeded:
        seeds = torch.from_numpy(rng.integers(-1, c["n"], (Q, 65))).to(
            "cuda")
    state = eng.seed_state(q, c["L"], seeds=seeds)
    t_limit = torch.full((Q,), c["T"], dtype=torch.int64, device="cuda")
    if Q > 1:
        t_limit[1::3] = c["T"] // 3
        t_limit[-3 if Q > 3 else -1] = 0
    return state, t_limit


def _cell_walk(eng, state, t_limit, resident):
    c = _CELL
    w = teng._Walk(eng, state, t_limit, c["k"], c["L"], c["B"], c["nbp"],
                   c["inject"] if state.get("spare_ids") is not None else 0,
                   0)
    assert w.fused
    if not resident:
        w.resident = False
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 4, 16, 256])
@pytest.mark.parametrize("seeded", [False, True], ids=["bkt", "kdt"])
def test_resident_walk_equals_three_launch_bodies_on_card(cell_engine,
                                                          monkeypatch, Q,
                                                          seeded):
    """At the cell's plan the resident kernel's T bodies give the state of
    T three-launch bodies (and of T plain bodies) bit for bit, at every
    cluster size, with pivot spares (BKT) and seeded with none (KDT)."""
    eng, data, rng = cell_engine
    state, t_limit = _cell_state(eng, data, rng, Q, seeded)
    want = _cell_walk(eng, _clone(state), t_limit, False)
    want.run_all(_CELL["T"])
    want = want.state()
    # the three-launch body is the plain body's (the first bodies merge
    # hundreds of candidates)
    plain = _cell_walk(eng, _clone(state), t_limit, False)
    plain.fused = False
    plain.run_all(_CELL["T"])
    _assert_same(want, plain.state(), f"Q {Q} three-launch")
    for cl in (1, 2, 4, 8):
        wb.reset_launch_counts()
        monkeypatch.setattr(wb, "cluster_for", lambda Q, sms, cl=cl: cl)
        w = _cell_walk(eng, _clone(state), t_limit, True)
        assert w.resident
        w.run_all(_CELL["T"])
        got = w.state()
        torch.cuda.synchronize()
        _assert_same(got, want, f"Q {Q} cluster {cl}")
        assert wb.launch_counts() == {**dict.fromkeys(wb.BODY_KERNELS, 0),
                                      "walk_resident": 1}


@pytest.mark.cuda
def test_resident_smem_agrees_with_the_kernel_layout(cuda):
    lib = wb.library()
    for plan in RESIDENT_PLANS.values():
        L, B, m, inject, N, D = plan
        assert lib.sptag_walk_resident_smem(
            L, B, m, inject, N, D, wb._hash_log2(B * m)) == \
            wb.resident_smem(*plan), plan


@pytest.mark.cuda
def test_plan_past_the_bitset_room_keeps_three_launches_on_card(cuda):
    """A corpus whose visited bitset does not fit a CTA's shared memory:
    a captured segment runs the three-launch body, with its bits."""
    rng = np.random.default_rng(21)
    n, m, D, L, B, T = 1_900_000, 8, 4, 64, 8, 4
    data = rng.integers(-4, 5, (n, D)).astype(np.float32)
    graph = rng.integers(0, n, (n, m)).astype(np.int32)
    eng = teng.GraphSearchEngine(data, graph, rng.choice(n, 256, False),
                                 None, DistCalcMethod.L2, 1, device=cuda)
    assert wb.resident_smem(L, B, m, 4, n, D) > wb.MAX_SMEM
    q = torch.from_numpy(data[:4] + 0.5).to(cuda)
    state = eng.seed_state(q, L)
    t_limit = torch.full((4,), T, dtype=torch.int64, device=cuda)
    plain = teng._Walk(eng, _clone(state), t_limit, 10, L, B, 3, 4, 0)
    plain.fused = False
    plain.run_all(T)
    wb.reset_launch_counts()
    graph_, bufs, t_in, _ = eng.capture_segment(_clone(state), t_limit, 10,
                                                L, B, 3, T, 4)
    for key, v in state.items():
        if v is not None:
            bufs[key].copy_(v)
    t_in.copy_(t_limit)
    graph_.replay()
    torch.cuda.synchronize()
    _assert_same(bufs, plain.state(), "past the bitset room")
    assert wb.launch_counts() == {**dict.fromkeys(wb.BODY_KERNELS, 2 * T),
                                  "walk_resident": 0}
