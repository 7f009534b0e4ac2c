"""Device time put down to the program's spans by launch (``chipbench.spans``),
on synthetic profiler events: a kernel counts to the range open at its
launch on the launching thread, however late it runs; a launch outside every
program range counts under ``none``. Then a wired one-shot run of a tiny
cell on the CPU: the program's spans land in the profile and name the gaps."""
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from chipbench import spans as SP  # noqa: E402
from chipbench.tests import _tiny  # noqa: E402

MS = 1_000_000      # ns


class Ev:
    """The part of a profiler event that the attribution reads."""

    def __init__(self, name, start, end, *, device=False, annotation=False, corr=0, thread=1):
        self._n, self._s, self._e = name, start, end
        self._dev, self._ann, self._corr, self._th = device, annotation, corr, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._th


def rng(name, a, b, thread=1):
    return Ev(name, a * MS, b * MS, annotation=True, thread=thread)


def launch(corr, at, thread=1, api="cudaLaunchKernel"):
    return Ev(api, at * MS, at * MS + 5000, corr=corr, thread=thread)


def kernel(name, corr, a, b):
    return Ev(name, a * MS, b * MS, device=True, corr=corr)


def _paths(events, t0=0, t1=1000):
    return {name: path for name, _, path in SP.attribute(events, t0 * MS, t1 * MS)}


def test_kernel_counts_to_its_launching_range_not_to_the_range_it_runs_in():
    evs = [rng("st", 0, 100), rng("st.step", 1, 40), rng("st.step.eps", 2, 30),
           rng("st.step.eps.layer.ssm.scan", 10, 11), rng("st.decode", 50, 60),
           launch(7, 10.5), kernel("ssd_scan_wgmma_kernel", 7, 55, 58)]
    got = SP.attribute(evs, 0, 1000 * MS)
    assert got == [("ssd_scan_wgmma_kernel", pytest.approx(3e-3), "st.step.eps.layer.ssm.scan")]


def test_innermost_range_wins_and_self_time_stays_with_the_parent():
    evs = [rng("st", 0, 100), rng("st.step", 1, 40), rng("st.step.eps", 2, 30),
           launch(1, 3), kernel("k_eps", 1, 3, 4),
           launch(2, 35, api="cuLaunchKernelEx"), kernel("fused_ab_kernel", 2, 41, 42),
           launch(3, 0.5), kernel("k_prior", 3, 1, 2)]
    assert _paths(evs) == {"k_eps": "st.step.eps", "fused_ab_kernel": "st.step",
                           "k_prior": "st"}


def test_launch_outside_every_program_range_is_none():
    evs = [rng("chipbench.sample", 0, 100), rng("st", 1, 50),
           launch(1, 60, api="cudaMemcpyAsync"), kernel("Memcpy DtoH", 1, 60, 61),
           launch(2, 200), kernel("late", 2, 200, 201)]
    assert _paths(evs) == {"Memcpy DtoH": SP.NONE, "late": SP.NONE}


def test_only_the_launching_thread_counts():
    evs = [rng("st", 0, 100, thread=1), rng("other", 0, 100, thread=2),
           launch(1, 10, thread=2), kernel("k", 1, 10, 11),
           launch(2, 10, thread=3), kernel("k3", 2, 10, 11)]
    assert _paths(evs) == {"k": "other", "k3": SP.NONE}


def test_correlation_ids_of_other_kinds_do_not_pass_for_launches():
    """An operator or a range may carry a kernel's correlation id (another
    counter); only a runtime or driver call is a launch, and a kernel whose
    launch is missing is left out."""
    evs = [rng("st", 0, 100), rng("st.late", 150, 160),
           Ev("aten::clone", 150 * MS, 151 * MS, corr=4),
           launch(4, 10), kernel("k", 4, 10, 11),
           kernel("orphan", 5, 12, 13)]
    assert _paths(evs) == {"k": "st"}


def test_time_is_clipped_to_the_window_and_sums_by_span():
    evs = [rng("st", 0, 100), rng("st.a", 10, 20),
           launch(1, 5), kernel("k1", 1, 5, 15),
           launch(2, 11), kernel("k2", 2, 18, 30),
           launch(3, 12), kernel("k3", 3, 40, 41)]
    by = SP.by_span(evs, 10 * MS, 35 * MS)
    assert by == {"st": pytest.approx(5e-3), "st.a": pytest.approx(12e-3)}


def test_equal_instants_end_before_start_before_launch():
    evs = [rng("st", 0, 100), rng("st.a", 10, 20), rng("st.b", 20, 30),
           launch(1, 20), kernel("k", 1, 20, 21)]
    assert _paths(evs) == {"k": "st.b"}


def _ctx(by_span, gaps, calls=2):
    mix = {"batch": 2, "seq_len": 4, "nfe": 5}
    toks = calls * 2 * 4 * 5
    trace = types.SimpleNamespace(by_span=by_span, gaps=gaps)
    return types.SimpleNamespace(trace=trace, kind="oneshot", mix=mix,
                                 work=lambda traced=False: (toks, 0.0))


def test_the_three_metrics_read_their_spans():
    e = "sample_tokens.sample.step.eps"
    by = {f"{e}.layer.ssm": 0.001, f"{e}.layer.ssm.pre": 0.002, f"{e}.layer.ssm.post": 0.003,
          f"{e}.layer.ssm.scan": 0.004, f"{e}.layer.norm": 0.5, "sample_tokens.sample.step": 0.5,
          SP.NONE: 0.5}
    gaps = [("sample_tokens", 0.010), (f"{e}.layer.ssm.pre", 0.002),
            ("chipbench.sample > aten::to", 0.5), ("none", 0.5)]
    ctx = _ctx(by, gaps)
    assert SP.ssm_mixer_ms_per_ktok(ctx) == pytest.approx(0.010 * 1e6 / 80)
    assert SP.ssm_pointwise_ms_per_ktok(ctx) == pytest.approx(0.005 * 1e6 / 80)
    assert SP.oneshot_idle_ms_per_call(ctx) == pytest.approx(12.0 / 2)


def test_metrics_read_nothing_without_spans():
    ctx = _ctx({}, [("chipbench.sample > aten::to", 0.5)])
    assert [f(ctx) for f in SP.METRICS.values()] == [None, None, None]
    ctx.trace = None
    assert [f(ctx) for f in SP.METRICS.values()] == [None, None, None]


def test_idle_by_span_names_gaps_by_the_open_range_however_far_back():
    evs = [rng("st", 0, 100)] + [rng(f"st.x{i}", 1 + i * 0.1, 1.05 + i * 0.1)
                                 for i in range(300)] + [rng("chipbench.sample", 0, 200)]
    tr = types.SimpleNamespace(ops=[("k", 0.0, 0.05), ("k", 0.06, 0.15)], window_s=0.2)
    got = SP.idle_by_span(evs, tr, 0)
    assert got == {"st": pytest.approx(0.01), SP.NONE: pytest.approx(0.05)}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return _tiny.write(tmp_path_factory.mktemp("tiny"))


def test_wired_tiny_oneshot_run_puts_the_program_spans_in_the_profile(base):
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    tracer, seen = Tracer(MetricsRegistry(), annotate=True), {}
    with SP.wired(tracer, seen):
        res = _tiny.run("tiny-ssm.oneshot", base, trace=True)
    calls = tracer.registry.get("trace_sample_tokens_seconds").count
    assert res["correct"] and calls >= 2
    assert "sample_tokens.sample.step.eps.layer.ssm.scan" in tracer.span_names()
    assert seen["ops"] == [] and seen["checks"]["by_span"] == {}     # no card: no device op
    assert "ssm_mixer_ms_per_ktok.batch" not in res["metrics"]
    labels = [k for k, _ in res["breakdown"]["idle_gaps"]]
    assert any(k.startswith("sample_tokens") for k in labels), labels
    # the seams are put back
    from chipbench import spec
    from chipbench import trace as TR
    import repro_torch.diffusion.lm as LM
    assert LM.sample_tokens.__module__ == "repro_torch.diffusion.lm"
    assert TR.reduce.__module__ == "chipbench.trace" and spec.reader.__module__ == "chipbench.spec"
