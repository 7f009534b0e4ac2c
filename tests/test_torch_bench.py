"""The port's ``BENCH_*.json`` records and ratchet (``repro_torch.obs.bench``),
mirroring the six ``test_bench_*`` of ``tests/test_obs.py``, and the records
crossing between the two packages: one the port writes loads and compares
clean in ``repro.obs.bench``, and one the reference writes in the port's."""
import pytest
import torch

from repro.obs import bench as ref_bench
from repro_torch.obs import bench


def _rec(metrics):
    return bench.record("t", metrics, {"quick": True})


def test_bench_metric_validates_direction():
    with pytest.raises(ValueError):
        bench.metric(1.0, direction="sideways")


def test_bench_write_load_roundtrip(tmp_path):
    p = tmp_path / "BENCH_t.json"
    rec = _rec({"m": bench.metric(1.0, unit="us", ratchet=True, tol=0.0)})
    bench.write(str(p), rec)
    assert bench.load(str(p))["metrics"] == rec["metrics"]
    p.write_text('{"schema": "bench.v0"}')
    with pytest.raises(ValueError):
        bench.load(str(p))


def test_bench_self_compare_is_clean():
    rec = _rec({"m": bench.metric(3.0, ratchet=True, tol=0.0),
                "z": bench.metric(0.0, ratchet=True, tol=0.0)})
    assert bench.regressions(bench.compare(rec, rec)) == []


def test_bench_ratchet_directions_and_tol():
    base = _rec({
        "wasted": bench.metric(0.0, direction="lower", ratchet=True, tol=0.0),
        "joined": bench.metric(4.0, direction="higher", ratchet=True, tol=0.0),
        "lat": bench.metric(100.0, direction="lower", ratchet=True, tol=0.1),
        "info": bench.metric(100.0, direction="lower", ratchet=False),
    })
    cur = _rec({
        "wasted": bench.metric(1.0),     # worse (lower is better)
        "joined": bench.metric(3.0),     # worse (higher is better)
        "lat": bench.metric(109.0),      # within 10% tol
        "info": bench.metric(500.0),     # worse but not ratcheted
    })
    by_name = {c.name: c for c in bench.compare(base, cur)}
    assert by_name["wasted"].regressed
    assert by_name["joined"].regressed
    assert not by_name["lat"].regressed
    assert not by_name["info"].regressed
    cur2 = _rec({"lat": bench.metric(111.0)})   # past the 10% tol
    assert bench.compare(base, cur2)[0].regressed


def test_bench_new_and_dropped_metrics_do_not_fail():
    base = _rec({"old": bench.metric(1.0, ratchet=True, tol=0.0)})
    cur = _rec({"new": bench.metric(9.0, ratchet=True, tol=0.0)})
    assert bench.compare(base, cur) == []      # no shared metrics


def test_bench_cli_compare(tmp_path, capsys):
    pb, pc = str(tmp_path / "b.json"), str(tmp_path / "c.json")
    bench.write(pb, _rec({"m": bench.metric(1.0, ratchet=True, tol=0.0)}))
    bench.write(pc, _rec({"m": bench.metric(1.0, ratchet=True, tol=0.0)}))
    assert bench.main(["compare", pb, pc]) == 0
    assert "ratchet clean" in capsys.readouterr().out
    bench.write(pc, _rec({"m": bench.metric(2.0)}))
    assert bench.main(["compare", pb, pc]) == 1
    assert bench.main(["show", pb]) == 0


def test_bench_meta_names_torch_and_the_device():
    rec = _rec({})
    assert rec["meta"] == {"torch": torch.__version__, "device": "cpu", "quick": True}
    assert "jax" not in rec["meta"]
    assert bench.record("t", {}, {"device": "given"})["meta"]["device"] == "given"


def _metrics(mod):
    return {"wasted": mod.metric(0.0, ratchet=True, tol=0.0),
            "lat": mod.metric(12.5, unit="ms", direction="lower", ratchet=True, tol=0.1),
            "joined": mod.metric(4.0, direction="higher", ratchet=True, tol=0.0),
            "info": mod.metric(7.0)}


def test_port_record_loads_and_compares_clean_in_the_reference(tmp_path):
    p = str(tmp_path / "BENCH_port.json")
    bench.write(p, bench.record("serving", _metrics(bench), {"quick": True}))
    rec = ref_bench.load(p)
    assert ref_bench.regressions(ref_bench.compare(rec, rec)) == []
    assert ref_bench.main(["compare", p, p]) == 0


def test_reference_record_loads_and_compares_clean_in_the_port(tmp_path):
    p = str(tmp_path / "BENCH_ref.json")
    ref_bench.write(p, ref_bench.record("serving", _metrics(ref_bench), {"quick": True}))
    rec = bench.load(p)
    comps = bench.compare(rec, rec)
    assert len(comps) == 4 and bench.regressions(comps) == []
    assert bench.main(["compare", p, p]) == 0
    # and across: the port's fresh record against the reference's baseline
    cur = bench.record("serving", _metrics(bench), {"quick": True})
    assert bench.regressions(bench.compare(rec, cur)) == []
