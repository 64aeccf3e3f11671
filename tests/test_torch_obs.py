"""The port's observability (``repro_torch.obs``), autotune and metrics
endpoint against the JAX reference's (``repro.obs``).

* metrics: the same calls give the reference's snapshot and Prometheus
  text, byte for byte;
* the tracer: JSON lines byte-identical across two runs under a fake
  clock, the Chrome export, and a traced ``execute`` bit-identical to an
  untraced one (spans read the host's clock and never wait for the card);
* the drift ledger: ``plan_signature`` and ``problem_key`` give the
  reference's strings for the same plan and problem, a JSON round trip, a
  re-rank and the drift report, and ``autotune`` skipping what the ledger
  holds;
* ``MetricsServer`` on 127.0.0.1, port 0.

Inputs are made with numpy from a seed; everything runs on the CPU.
"""
import itertools
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import obs as jobs
from repro.exec import CGProblem as JaxCGProblem
from repro.exec import Plan as JaxPlan
from repro.exec import StencilProblem as JaxStencilProblem
from repro.kernels.common import get_spec as jax_get_spec
from repro_torch import obs
from repro_torch.exec import (BatchedProblem, CGProblem, Plan,
                              StencilProblem, autotune, execute,
                              plan_candidates)
from repro_torch.kernels.common import get_spec
from repro_torch.runtime.server import start_metrics_server
from repro_torch.sparse.generate import poisson2d


def _tick_clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _x(shape=(32, 32), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stencil(seed=0, steps=8, shape=(32, 32)):
    return StencilProblem(_x(shape, seed), get_spec("2d5pt"), steps,
                          device="cpu")


def _cg(seed=0, iters=12, tol=None, side=16):
    ell = poisson2d(side).to_ell()
    b = np.random.default_rng(seed).standard_normal(
        ell.data.shape[0]).astype(np.float32)
    return ell, b, CGProblem.from_ell(ell.data, ell.cols, b, iters, tol=tol,
                                      device="cpu")


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- metrics -------------------------------------------------------------------


def _feed(reg):
    reg.counter("requests_total", help="requests served",
                tier="resident").inc()
    reg.counter("requests_total", tier="resident").inc(2)
    reg.counter("requests_total", tier="host_loop").inc()
    reg.gauge("depth").set(7)
    reg.gauge("depth").dec(2)
    h = reg.histogram("latency_s", help="end to end")
    for v in (0.1, 0.2, 0.3, 0.4, 0.25):
        h.observe(v)
    reg.histogram("exec_s", kind="cg").observe(0.125)


def test_metrics_match_the_reference_call_for_call():
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _feed(reg)
    _feed(jreg)
    assert reg.prometheus_text() == jreg.prometheus_text()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.value("requests_total", tier="resident") == 3
    assert reg.total("requests_total") == 4
    assert list(reg.names()) == list(jreg.names())
    assert "# TYPE latency_s summary\n" in reg.prometheus_text()
    with pytest.raises(ValueError):
        reg.counter("requests_total", tier="resident").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("requests_total", tier="resident")


# -- tracer --------------------------------------------------------------------


def _trace_once(mod):
    tr = mod.Tracer(clock=_tick_clock())
    tr.event("barrier", cat="barrier", track="lanes:a", occupied=3)
    with tr.span("execute:x", cat="dispatch", track="tier:resident",
                 fuse_steps=4):
        tr.event("cache:dom", cat="cache", track="tier:resident",
                 cached_bytes=1024, total_bytes=4096, obj=object)
    return tr


def test_tracer_jsonl_byte_identical_across_runs_and_to_the_reference():
    t1, t2 = _trace_once(obs), _trace_once(obs)
    assert t1.to_jsonl() == t2.to_jsonl()
    assert t1.to_jsonl() == _trace_once(jobs).to_jsonl()
    assert len(t1) == 3
    ev = t1.by_cat("cache")[0]
    assert ev.args[:2] == (("cached_bytes", 1024), ("obj", str(object)))
    assert obs.CATEGORIES == jobs.CATEGORIES


def test_tracer_chrome_export_is_valid_and_tracked(tmp_path):
    tr = obs.Tracer(clock=_tick_clock())
    tr.event("chunk", cat="chunk", track="lanes:cg")
    with tr.span("drive", cat="dispatch", track="lanes:cg"):
        pass
    tr.event("plan", cat="plan", track="planner")
    doc = json.loads(json.dumps(tr.to_chrome()))
    evs = doc["traceEvents"]
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == {
        "lanes:cg", "planner"}
    assert all("dur" in e for e in evs if e["ph"] == "X")
    assert all(e["s"] == "t" for e in evs if e["ph"] == "i")
    tids = {e["tid"] for e in evs if e["ph"] == "M"}
    assert all(e["tid"] in tids for e in evs)
    path = tmp_path / "t.json"
    tr.write_chrome(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))


def test_null_tracer_records_nothing():
    nt = obs.NullTracer()
    for _ in range(100):
        nt.event("x", cat="chunk", a=1)
        with nt.span("y", cat="dispatch"):
            pass
    assert len(nt.events) == 0 and nt.enabled is False
    assert obs.get_tracer().enabled is False


@pytest.mark.parametrize("tier", ["host_loop", "device_loop", "resident"])
def test_traced_execute_is_bit_identical_to_untraced(tier):
    for prob in (_stencil(), _cg(tol=None if tier == "resident"
                                  else 1e-6)[2]):
        p = next((c for c in plan_candidates(prob) if c.tier == tier), None)
        if p is None:
            continue
        base = execute(prob, p)
        tr = obs.Tracer(clock=_tick_clock())
        with obs.use_tracer(tr):
            traced = execute(prob, p)
        _same(traced, base)
        assert tr.by_cat("dispatch")
        if tier == "host_loop":
            assert tr.by_cat("chunk") and tr.by_cat("barrier")
        assert obs.get_tracer().enabled is False


def test_executor_records_plan_metrics():
    p = _stencil()
    reg = obs.MetricsRegistry()
    with obs.use_metrics(reg):
        resident = next(c for c in plan_candidates(p) if c.tier == "resident")
        execute(p, resident)
        execute(p, Plan(tier="host_loop"))
    assert reg.value("executor_executions_total", tier="resident") == 1
    assert reg.value("executor_barriers_total",
                     tier="resident") == resident.barriers
    assert reg.value("executor_bytes_cached_total") == resident.cached_bytes
    assert reg.value("executor_retraces_total", tier="host_loop") == 1


# -- the drift ledger ----------------------------------------------------------


@pytest.mark.parametrize("fields", [
    dict(tier="host_loop"),
    dict(tier="device_loop", sync_every=25, batch=4),
    dict(tier="resident", cached_rows=24, fuse_steps=2),
    dict(tier="resident", schedule="deep", fuse_steps=8, cached_rows=0),
    dict(tier="resident", policy="MIX", block_rows=256, batch=2),
    dict(tier="host_loop", precision="mixed"),
    dict(tier="distributed", shard_axis="data", partition="nnz",
         fuse_reductions=True),
], ids=lambda f: f["tier"] + "-" + "-".join(sorted(f)[1:]))
def test_plan_signature_matches_the_reference(fields):
    assert obs.plan_signature(Plan(**fields)) == jobs.plan_signature(
        JaxPlan(**fields))


def test_problem_key_matches_the_reference():
    x = _x((24, 20))
    tp = StencilProblem(x, get_spec("2d9pt"), 7, device="cpu")
    jp = JaxStencilProblem(jnp.asarray(x), jax_get_spec("2d9pt"), 7)
    assert obs.problem_key(tp) == jobs.problem_key(jp)
    ell, b, cp = _cg(iters=9)
    jc = JaxCGProblem.from_ell(jnp.asarray(ell.data), jnp.asarray(ell.cols),
                               jnp.asarray(b), 9)
    assert obs.problem_key(cp) == jobs.problem_key(jc)
    bp = BatchedProblem.from_instances([tp, tp.with_payload(x + 1.0)])
    assert obs.problem_key(bp) == "batch2_stencil_2d9pt_b2_s7"


def test_ledger_keys_by_device_torch_and_cuda():
    p = _stencil()
    key = obs.DriftLedger.entry_key(p, "h100")
    assert key == (f"{obs.problem_key(p)}|h100|torch{torch.__version__}"
                   f"|cuda{torch.version.cuda}")
    assert obs.device_name(p, "h100") == "h100"     # a problem on the CPU


def test_ledger_round_trip_and_autotune_skips_remeasure(tmp_path):
    path = str(tmp_path / "ledger.json")
    p = _stencil()
    led = obs.DriftLedger(path)
    res1 = autotune(p, top_k=3, warmup=0, iters=1, ledger=led)
    assert led.hits == 0 and len(led) == 3
    assert led.best_signature(p, res1.best.chip) == obs.plan_signature(
        res1.best)
    assert all(r.measured_s > 0 for r in res1.table)
    led2 = obs.DriftLedger(path)                  # the next process
    assert len(led2) == 3
    assert led2.to_dict() == led.to_dict()
    res2 = autotune(p, top_k=3, warmup=0, iters=1, ledger=led2)
    assert led2.hits == 3 and led2.misses == 0
    assert [r.measured_s for r in res2.table] == [r.measured_s
                                                 for r in res1.table]
    assert res2.best == res1.best
    # the ambient ledger is what autotune reads by default
    with obs.use_ledger(led2):
        autotune(p, top_k=2, warmup=0, iters=1)
    assert led2.hits == 5


def test_ledger_reranks_plan_candidates():
    p = _stencil()
    led = obs.DriftLedger()
    cands = plan_candidates(p)[:3]
    led.record(p, cands[-1], 1e-6)
    led.record(p, cands[0], 1.0)
    reranked = plan_candidates(p, ledger=led)
    sigs = [obs.plan_signature(c) for c in reranked]
    assert sigs[0] == obs.plan_signature(cands[-1])
    assert sigs.index(obs.plan_signature(cands[0])) == 1


def test_drift_report_thresholds():
    p = _stencil()
    led = obs.DriftLedger()
    cands = plan_candidates(p)[:3]
    led.record(p, cands[0], cands[0].predicted_s * 100)
    led.record(p, cands[1], cands[1].predicted_s * 1.5)
    led.record(p, cands[2], cands[2].predicted_s / 100)
    rows = led.drift_report(threshold=4.0)
    assert len(rows) == 2
    assert sorted(r["prediction_ratio"] for r in rows) == pytest.approx(
        [0.01, 100], rel=1e-6)
    with pytest.raises(ValueError):
        led.drift_report(threshold=0.5)
    for _, _, rec in led.records():
        assert rec.predicted_s > 0 and math.isfinite(rec.prediction_ratio)


def test_execute_records_a_ledger_row_and_keeps_its_values():
    ell, b, p = _cg(iters=10)
    pl = Plan(tier="host_loop")
    base = execute(p, pl)
    led = obs.DriftLedger()
    with obs.use_ledger(led):
        got = execute(p, pl)
    _same(got, base)
    (key, sig, rec), = led.records()
    assert sig == obs.plan_signature(pl) and rec.measured_s > 0


# -- the metrics endpoint --------------------------------------------------------


def test_metrics_server_serves_prometheus_over_http():
    reg = obs.MetricsRegistry()
    reg.counter("served_total").inc(3)
    with start_metrics_server(reg, host="127.0.0.1", port=0) as srv:
        assert srv.port > 0
        with urllib.request.urlopen(srv.url(), timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        assert body == reg.prometheus_text()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{srv.host}:{srv.port}/nope",
                                   timeout=10)
