"""Parity of the port's fleet control plane (``repro_torch.serve``) with
the JAX reference.

The same seeded cells and traces go through both packages on the CPU,
each service on its own virtual clock with ``cost_smoothing=0``, so the
close decisions depend on the trace alone.  Tolerances:

* keys, traces and logs exactly: ``quantized_problem_key``'s bytes (the
  float32 leaves widened to float64 on the host in both), the arrival
  times, cells and rounds of ``poisson_trace``/``bursty_trace``, the
  ``BatchRecord`` log (sequence numbers, cells, buckets, close reasons,
  lanes) and ``counter_summary`` (requests, batches, warm starts, cache
  hits, closes, outer and inner iterations);
* the fault harness exactly: ``corrupt_problem``/``corrupt_trace``'s
  leaves (NaN where the reference has NaN), ``dropout_mask``,
  ``count_nonfinite``, and the selection flags ``a == 0`` of every
  response (sanitised devices deselect in both);
* every response's a* and P* at 1e-5 (P* as atol = rtol), the
  reference's solver tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as ref_serve
from repro.serve import faults as ref_faults
from repro.serve import fleet_service as ref_fs
from repro_torch import serve
from repro_torch.convert import problem_from_numpy
from repro_torch.serve import faults
from repro_torch.serve import fleet_service as fs

torch.set_num_threads(1)

TENSOR_FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j",
                 "dataset_size", "cycles_per_sample", "cpu_hz", "weights",
                 "fading", "interference", "bits")
CONSTANTS = ("grad_size_bits", "noise_power", "p_max", "tau_th", "kappa",
             "n_rounds")
SOLVE_TOL = 1e-5
# the golden suite's configuration (tests/test_openloop_golden.py)
CFG = dict(max_batch=4, cost_smoothing=0.0, record_batches=True)


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_problem(ref):
    fields = {f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
              for f in TENSOR_FIELDS}
    fields.update({c: getattr(ref, c) for c in CONSTANTS})
    return problem_from_numpy(fields, device="cpu")


def cells_both(n_cells=3, n_devices=12, n_rounds=4, seed=11, **kw):
    return (ref_serve.make_cells(n_cells, n_devices=n_devices,
                                 n_rounds=n_rounds, seed=seed, **kw),
            serve.make_cells(n_cells, n_devices=n_devices, n_rounds=n_rounds,
                             seed=seed, device="cpu", **kw))


def traces_both(kind, seed=3, n=36):
    ref_cells, cells = cells_both()
    if kind == "poisson":
        kw = dict(rate_hz=400.0, n_requests=n, seed=seed, deadline_s=0.05)
        return (ref_serve.poisson_trace(ref_cells, **kw),
                serve.poisson_trace(cells, **kw))
    kw = dict(burst_rate_hz=2000.0, burst_len=8, n_bursts=n // 8,
              idle_s=0.02, seed=seed, deadline_s=0.05)
    return ref_serve.bursty_trace(ref_cells, **kw), serve.bursty_trace(cells, **kw)


def assert_problem_equal(ref, got):
    for f in TENSOR_FIELDS:
        r, g = getattr(ref, f), getattr(got, f)
        assert (r is None) == (g is None), f
        if r is not None:
            np.testing.assert_array_equal(np_(g), np.asarray(r), err_msg=f)
    for c in CONSTANTS:
        assert getattr(got, c) == getattr(ref, c), c


def assert_traces_equal(ref, got):
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert (g.t, g.cell_id, g.round_k, g.deadline_s) == \
            (r.t, r.cell_id, r.round_k, r.deadline_s)
        assert_problem_equal(r.problem, g.problem)


def assert_responses(ref_responses, responses):
    want = {r.seq: r for r in ref_responses}
    got = {r.seq: r for r in responses}
    assert sorted(got) == sorted(want)
    for s, r in want.items():
        g = got[s]
        assert (g.cell_id, g.warm_started, g.cache_hit, g.deadline_missed,
                g.converged, g.n_iters, g.n_unhealthy, g.retried, g.shed) == \
            (r.cell_id, r.warm_started, r.cache_hit, r.deadline_missed,
             r.converged, int(r.n_iters), r.n_unhealthy, r.retried, r.shed)
        ra, rp = np.asarray(r.solution.a), np.asarray(r.solution.power)
        np.testing.assert_array_equal(g.solution.a == 0, ra == 0)
        np.testing.assert_allclose(g.solution.a, ra, atol=SOLVE_TOL, rtol=0)
        np.testing.assert_allclose(g.solution.power, rp, atol=SOLVE_TOL,
                                   rtol=SOLVE_TOL)


# ------------------------------------------------------------ keys, policy

def _leafy(ref, **leaves):
    return dataclasses.replace(ref, **{f: jnp.asarray(np.asarray(v, np.float32))
                                       for f, v in leaves.items()})


@pytest.mark.parametrize("leaves", ["plain", "fading", "interference", "bits"])
@pytest.mark.parametrize("decimals", [2, 4])
def test_quantized_problem_key_bytes_equal(leaves, decimals):
    ref_cells, _ = cells_both(n_cells=1, n_devices=10, n_rounds=3)
    ref = ref_cells[0]
    if leaves == "plain":
        ref = dataclasses.replace(ref, fading=None, n_rounds=1)
    elif leaves == "interference":
        ref = _leafy(ref, interference=np.linspace(0.0, 1e-11, 10))
    elif leaves == "bits":
        ref = _leafy(ref, bits=np.full((10, 3), 8.0))
    want = ref_fs.quantized_problem_key(ref, decimals)
    got = fs.quantized_problem_key(port_problem(ref), decimals)
    assert got == want
    assert fs._compat_key(port_problem(ref)) == ref_fs._compat_key(ref)


def _req(mod, seq, t_submit, deadline=float("inf")):
    return mod.SolveRequest(cell_id=seq, problem=None, t_submit=t_submit,
                            t_deadline=deadline, ckey=0, seq=seq)


@pytest.mark.parametrize("case", [
    ([], 0.0, 1.0),                                          # empty: None
    ([(0, 0.0, 9.0)] * 4, 0.0, 1e-3),                        # full
    ([(0, 0.0, 1.0)], 0.0, 0.1),                             # slack: None
    ([(0, 0.0, 1.0)], 0.85, 0.1),                            # deadline
    ([(0, 0.0, 10.0), (1, 0.1, 1.0)], 0.85, 0.1),            # tightest
    ([(0, 0.0, float("inf"))], 4e-3, 1e-4),                  # no linger yet
    ([(0, 0.0, float("inf"))], 5e-3, 1e-4),                  # linger
    ([(0, 0.0, 1.0), (1, 1e-3, 2.0)], 2e-3, 1e-3),           # all slack
], ids=["empty", "full", "slack", "deadline", "tightest", "early", "linger",
        "none"])
def test_batch_close_reason_cases(case):
    reqs, now, cost = case
    cfg = dict(max_batch=4, close_safety=1.5, max_linger_s=5e-3)
    want = ref_fs.batch_close_reason([_req(ref_fs, *r) for r in reqs], now,
                                     cost, ref_fs.ServiceConfig(**cfg))
    got = fs.batch_close_reason([_req(fs, *r) for r in reqs], now, cost,
                                fs.ServiceConfig(**cfg))
    assert got == want


def test_next_pow2_cost_model_and_lru():
    for n, floor in [(0, 1), (1, 8), (9, 8), (64, 8), (65, 1), (5, 12)]:
        assert fs._next_pow2(n, floor) == ref_fs._next_pow2(n, floor)
    ref_m, m = ref_fs.BucketCostModel(5e-3, 0.3), fs.BucketCostModel(5e-3, 0.3)
    for bucket, sec in [(8, 1e-2), (8, 2e-2), (16, 3e-3)]:
        ref_m.observe(bucket, sec)
        m.observe(bucket, sec)
    ref_m.scale(50.0)
    m.scale(50.0)
    assert [m.estimate(b) for b in (8, 16, 32)] == \
        [ref_m.estimate(b) for b in (8, 16, 32)]
    lru = fs._LRU(2)
    for k in "abc":
        lru.put(k, k)
    assert lru.get("a") is None and lru.get("c") == "c" and len(lru) == 2


# ----------------------------------------------------------------- traces

@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_traces_bit_for_bit(kind):
    ref, got = traces_both(kind, seed=5, n=40)
    assert_traces_equal(ref, got)


# -------------------------------------------------------------- the service

@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("method,power_solver", [
    ("fused", None), ("fused", "dinkelbach"), ("alternating", None)])
def test_service_log_and_counters_equal_reference(kind, method, power_solver):
    ref_trace, trace = traces_both(kind)
    cfg = dict(CFG, method=method, power_solver=power_solver)
    ref_svc = ref_serve.FleetControlService(ref_serve.ServiceConfig(**cfg))
    svc = serve.FleetControlService(serve.ServiceConfig(**cfg), device="cpu")
    ref_rep = ref_serve.drive(ref_svc, ref_trace, clock="virtual")
    rep = serve.drive(svc, trace, clock="virtual")
    assert len(svc.batch_log) > 1 and any(len(r.seqs) > 1 for r in svc.batch_log)
    assert svc.batch_log == ref_svc.batch_log
    assert svc.stats.counter_summary() == ref_svc.stats.counter_summary()
    assert any(r.warm_started for r in rep.responses)
    assert_responses(ref_rep.responses, rep.responses)


def test_closed_loop_stream_and_seed_cell_match_reference():
    """The demo's closed-loop stream (``run`` per round) and a fresh
    service re-seeded from the reference's last answers."""
    ref_cells, cells = cells_both(n_cells=3, n_devices=10, n_rounds=3)
    cfg = dict(max_batch=2, power_solver="dinkelbach")
    ref_svc = ref_serve.FleetControlService(ref_serve.ServiceConfig(**cfg))
    svc = serve.FleetControlService(serve.ServiceConfig(**cfg), device="cpu")
    from repro.core.scenarios import slice_round as ref_slice
    from repro_torch.core.scenarios import slice_round
    for k in range(3):
        want = ref_svc.run([(c, ref_slice(p, k)) for c, p in enumerate(ref_cells)])
        got = svc.run([(c, slice_round(p, k)) for c, p in enumerate(cells)])
        assert_responses(want, got)
    assert svc.stats.counter_summary() == ref_svc.stats.counter_summary()
    fresh = serve.FleetControlService(serve.ServiceConfig(**cfg), device="cpu")
    ref_fresh = ref_serve.FleetControlService(ref_serve.ServiceConfig(**cfg))
    for c, r in enumerate(want):
        ref_fresh.seed_cell(c, ref_slice(ref_cells[c], 2), r.solution)
        fresh.seed_cell(c, slice_round(cells[c], 2), r.solution)
    want = ref_fresh.run([(c, ref_slice(p, 2)) for c, p in enumerate(ref_cells)])
    got = fresh.run([(c, slice_round(p, 2)) for c, p in enumerate(cells)])
    assert all(r.cache_hit for r in got)
    assert_responses(want, got)


def test_warmup_and_capacity():
    _, cells = cells_both(n_cells=2, n_devices=20, n_rounds=2)
    svc = serve.FleetControlService(serve.ServiceConfig(max_batch=2),
                                    device="cpu")
    from repro_torch.core.scenarios import slice_round
    probe = [slice_round(c, 0) for c in cells]
    times = svc.warmup(probe[0], max_devices=40)
    assert sorted(times) == [8, 16, 32, 64] == sorted(svc.warmed_buckets)
    assert svc.stats.n_requests == 0 and svc.pending == 0
    cap = serve.measure_capacity(svc, probe, repeats=2)
    assert cap > 0 and svc.pending == 0 and svc.stats.n_batches == 2


def test_service_solve_coupled_warm_ticks_match_reference():
    from repro.core import scenarios as ref_scenarios
    from repro_torch.core import scenarios
    kw = dict(seed=0, n_cells=3, n_devices=12)
    ref_mc = ref_scenarios.make_problem("metro_coupled", **kw)
    mc = scenarios.make_problem("metro_coupled", device="cpu", **kw)
    ref_svc = ref_serve.FleetControlService(ref_serve.ServiceConfig())
    svc = serve.FleetControlService(serve.ServiceConfig(), device="cpu")
    for tick in range(2):
        want = ref_svc.solve_coupled("m", ref_mc)
        got = svc.solve_coupled("m", mc)
        assert got.warm_started == want.warm_started == (tick == 1)
        assert got.n_cells == 3
        assert got.solution.outer_iters == want.solution.outer_iters
        np.testing.assert_allclose(np_(got.solution.batch.a),
                                   np.asarray(want.solution.batch.a),
                                   atol=SOLVE_TOL, rtol=0)
    assert svc.stats.counter_summary() == ref_svc.stats.counter_summary()


# ------------------------------------------------------------- the faults

@pytest.mark.parametrize("kind", faults.CHANNEL_KINDS)
@pytest.mark.parametrize("with_fading", [True, False])
def test_corrupt_problem_equals_reference(kind, with_fading):
    ref_cells, _ = cells_both(n_cells=1, n_devices=16, n_rounds=3)
    ref = ref_cells[0]
    if not with_fading:
        ref = dataclasses.replace(ref, fading=None, n_rounds=1)
    want = ref_faults.corrupt_problem(ref, kind, rng=np.random.default_rng(4),
                                      device_rate=0.25)
    got = faults.corrupt_problem(port_problem(ref), kind,
                                 rng=np.random.default_rng(4),
                                 device_rate=0.25)
    assert_problem_equal(want, got)
    np.testing.assert_array_equal(got.health_mask(xp=np),
                                  want.health_mask(xp=np))


def test_corrupt_trace_and_dropout_mask_equal_reference():
    ref_trace, trace = traces_both("poisson", seed=7, n=24)
    plan = dict(kinds=faults.FAULT_KINDS, seed=5, fault_rate=0.5,
                device_rate=0.2)
    want, n_want = ref_faults.corrupt_trace(ref_trace,
                                            ref_faults.FaultPlan(**plan))
    got, n_got = faults.corrupt_trace(trace, faults.FaultPlan(**plan))
    assert n_got == n_want > 0
    assert_traces_equal(want, got)
    for args in [(0, 5, 16, 0.1), (3, 2, 7, 0.5)]:
        np.testing.assert_array_equal(faults.dropout_mask(*args),
                                      ref_faults.dropout_mask(*args))


@pytest.mark.parametrize("seed", [2, 9])
def test_chaos_drive_matches_reference(seed):
    ref_trace, trace = traces_both("poisson", seed=seed, n=40)
    plan = dict(kinds=faults.FAULT_KINDS, seed=seed, fault_rate=0.5,
                device_rate=0.25)
    ref_svc = ref_serve.FleetControlService(ref_serve.ServiceConfig(**CFG))
    svc = serve.FleetControlService(serve.ServiceConfig(**CFG), device="cpu")
    want = ref_faults.chaos_drive(ref_svc, ref_trace,
                                  ref_faults.FaultPlan(**plan))
    got = faults.chaos_drive(svc, trace, faults.FaultPlan(**plan))
    assert got.nan_escapes == want.nan_escapes == 0
    assert faults.count_nonfinite(got.report.responses) == \
        ref_faults.count_nonfinite(want.report.responses)
    assert (got.n_faulted, got.n_unconverged, got.n_shed,
            got.n_unhealthy_devices) == \
        (want.n_faulted, want.n_unconverged, want.n_shed,
         want.n_unhealthy_devices)
    assert got.n_unhealthy_devices > 0
    assert got.counters == want.counters
    assert svc.batch_log == ref_svc.batch_log
    assert_responses(want.report.responses, got.report.responses)


def test_retry_breaker_and_shed_follow_reference():
    """Force the fast path to report non-convergence in both services:
    the retry, the backoff, the breaker and the shed answers agree."""
    ref_cells, cells = cells_both(n_cells=1, n_devices=12, n_rounds=1)
    from repro.core.scenarios import slice_round as ref_slice
    from repro_torch.core.scenarios import slice_round
    cfg = dict(retry_unconverged=False, breaker_threshold=2,
               breaker_cooldown=2)
    ref_svc = ref_serve.FleetControlService(ref_serve.ServiceConfig(**cfg))
    svc = serve.FleetControlService(serve.ServiceConfig(**cfg), device="cpu")
    ref_solve, solve = ref_svc._solve, svc._solve
    ref_svc._solve = lambda b, init: ref_solve(b, init)._replace(
        converged=jnp.zeros(b.batch_size, bool))
    svc._solve = lambda b, init: solve(b, init)._replace(
        converged=torch.zeros(b.batch_size, dtype=torch.bool))
    for _ in range(4):
        want = ref_svc.run([("c", ref_slice(ref_cells[0], 0))])
        got = svc.run([("c", slice_round(cells[0], 0))])
        assert_responses(want, got)
    assert svc.stats.summary()["retry_backoff_s"] == \
        ref_svc.stats.summary()["retry_backoff_s"]
    assert svc.stats.counter_summary() == ref_svc.stats.counter_summary()
    assert svc.stats.n_shed == 2
