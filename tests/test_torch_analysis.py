"""repro_torch.analysis, the port's static analyzer: the reference's ten
checks of ``tests/test_analysis.py`` over torch-idiom fixtures
(``tests/torch_analysis_fixtures``; RL005's sit under ``kernels/``, where
its except-handler rule applies), the live port tree, one mutation of
that tree per rule (each must fail with exactly its rule, once), and
where the two frameworks agree, the same files through both analyzers:
equal ``(rule, line, col)`` lists, JSON keys and bench records."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import RULES, analyze, main, write_bench
from repro_torch.analysis.cli import PACKAGE_DIR

ROOT = Path(__file__).resolve().parents[1]
FIX = ROOT / "tests" / "torch_analysis_fixtures"
REF_FIX = ROOT / "tests" / "analysis_fixtures"
PKG = ROOT / "src" / "repro_torch"

# (rule, fixture stem, expected violation count in the known-bad file);
# counts are exact so a checker that silently stops firing breaks loudly.
CASES = [("RL001", "rl001", 11), ("RL002", "rl002", 8),
         ("RL003", "rl003", 4), ("RL004", "rl004", 5),
         ("RL005", "kernels/rl005", 4)]


@pytest.mark.parametrize("rule,stem,expected", CASES)
def test_bad_fixture_flags(rule, stem, expected):
    report = analyze([str(FIX / f"{stem}_bad.py")])
    assert report.exit_code == 1
    assert report.counts()[rule] == expected
    assert {v.rule for v in report.active} == {rule}


@pytest.mark.parametrize("rule,stem,expected", CASES)
def test_good_fixture_clean(rule, stem, expected):
    report = analyze([str(FIX / f"{stem}_good.py")])
    assert report.exit_code == 0 and not report.violations


def test_suppression_allows_but_reports():
    report = analyze([str(FIX / "suppressed.py")])
    assert report.exit_code == 0
    assert [v.rule for v in report.allowed] == ["RL001"]
    assert "[allowed]" in report.human()


def test_cli_exit_codes(tmp_path, capsys):
    assert main([str(FIX / "rl001_good.py")]) == 0
    assert main([str(FIX / "rl001_bad.py")]) == 1
    assert main(["--rules", "NOPE", str(FIX)]) == 2
    assert main([str(tmp_path / "missing.txt")]) == 2
    capsys.readouterr()


def test_cli_rule_subset(capsys):
    # RL001 findings are invisible to an RL002-only run
    assert main(["--rules", "RL002", str(FIX / "rl001_bad.py")]) == 0
    capsys.readouterr()


def test_cli_json(capsys):
    main(["--json", str(FIX / "rl003_bad.py")])
    data = json.loads(capsys.readouterr().out)
    assert data["counts"]["RL003"] == 4
    v = data["violations"][0]
    assert {"rule", "path", "line", "col", "message", "allowed"} <= set(v)


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert RULES == ("RL001", "RL002", "RL003", "RL004", "RL005")
    assert all(rule in out for rule in RULES)


def test_syntax_error_is_rl000(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    report = analyze([str(bad)])
    assert report.exit_code == 1
    assert [v.rule for v in report.active] == ["RL000"]


def test_bench_record(tmp_path):
    out = tmp_path / "BENCH_static.json"
    report = analyze([str(FIX / "rl002_bad.py")])
    write_bench(report, str(out), ["fixtures"])
    rec = json.loads(out.read_text())
    m = rec["metrics"]["static.RL002.violations"]
    assert m["value"] == 8 and m["ratchet"] and m["tol"] == 0.0
    assert m["direction"] == "lower"
    assert rec["metrics"]["static.files"]["value"] == 1
    assert rec["meta"]["rules"] == list(RULES)


def test_live_tree_clean(capsys):
    """The committed port passes its own analyzer, by the default target
    (the package directory) and named; any new violation must be fixed or
    carry a justified ``# repro: allow[RULE]``."""
    assert Path(PACKAGE_DIR) == PKG
    for argv in ([], [str(PKG)]):
        code = main(argv)
        out = capsys.readouterr().out
        assert code == 0, out
    report = analyze([str(PKG)])
    assert report.files == len(list(PKG.rglob("*.py")))
    assert report.counts() == dict.fromkeys(RULES, 0)


def test_runs_without_torch_or_jax(tmp_path):
    """The analyzer parses source and imports none of it: a whole run with
    ``--json --bench`` loads no torch, JAX or reference module."""
    code = ("import sys; from repro_torch.analysis import main; "
            f"rc = main([{str(PKG)!r}, '--json', '--bench', {str(tmp_path / 'b.json')!r}]); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro', 'numpy')); "
            "print('LOADED', bad); sys.exit(rc or bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout


# ------------------------------------------------------------- mutations
def _plan_ab_key(src):
    head, tail = src.split("def plan_ab(", 1)
    return head + "def plan_ab(" + tail.replace(
        'coeffs = {"psi": psi, "C": Cm}', 'coeffs = {"psi": psi, "C": Cm, "gain": psi}', 1)


MUTATIONS = {
    # the boundary read at _row_values loses its justification
    "RL001-allow-deleted": ("RL001", "serving/engine.py", lambda s: s.replace(
        "        # repro: allow[RL001] the host reads these values at a boundary by design\n",
        "")),
    "RL001-tolist-in-step": ("RL001", "core/sampler.py", lambda s: s.replace(
        "    plan = plan.astype(state.x.dtype)\n",
        "    plan = plan.astype(state.x.dtype)\n    seen = state.err.tolist()\n", 1)),
    "RL002-fstring-executor-key": ("RL002", "serving/engine.py", lambda s: s.replace(
        "key_ = (sig, batch, seq_len, self._mesh_key)",
        'key_ = (f"{sig}", batch, seq_len, self._mesh_key)')),
    "RL003-scheduler-attr-from-submit": ("RL003", "serving/driver.py", lambda s: s.replace(
        "        stream = ServeStream(request.uid)\n",
        "        stream = ServeStream(request.uid)\n        self.engine._arrivals = 0\n")),
    "RL004-unregistered-plan-ab-key": ("RL004", "core/plan.py", _plan_ab_key),
    "RL005-cpu-device-default": ("RL005", "launch/serve.py", lambda s: s.replace(
        "def _serve(args, device, sharded: bool)",
        'def _serve(args, device="cpu", sharded: bool = False)')),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_fails_with_its_rule(tmp_path, case):
    rule, rel, edit = MUTATIONS[case]
    tree = tmp_path / "repro_torch"
    shutil.copytree(PKG, tree, ignore=shutil.ignore_patterns("__pycache__"))
    target = tree / rel
    src = target.read_text()
    mutated = edit(src)
    assert mutated != src, f"{case}: the edit no longer applies to {rel}"
    target.write_text(mutated)
    report = analyze([str(tree)])
    assert [(v.rule, Path(v.path).name) for v in report.active] == \
        [(rule, target.name)], report.human()


# --------------------------------------------------- against the reference
def _sites(report):
    return sorted((v.rule, v.line, v.col, v.allowed) for v in report.violations)


@pytest.mark.parametrize("path", [REF_FIX / "rl003_bad.py", REF_FIX / "rl003_good.py",
                                  REF_FIX / "suppressed.py"], ids=lambda p: p.name)
def test_agrees_with_reference_on_shared_fixtures(path):
    want = ref_analysis.analyze([str(path)])
    got = analyze([str(path)])
    assert _sites(got) == _sites(want)
    assert got.exit_code == want.exit_code


def test_syntax_error_agrees_with_reference(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("x = 1\ndef oops(:\n")
    assert _sites(analyze([str(bad)])) == _sites(ref_analysis.analyze([str(bad)])) \
        == [("RL000", 2, 0, False)]


def test_json_and_bench_keys_agree_with_reference(tmp_path, capsys):
    path = str(REF_FIX / "rl003_bad.py")
    ref_b, got_b = tmp_path / "ref.json", tmp_path / "port.json"
    assert ref_analysis.main(["--json", "--bench", str(ref_b), path]) == 1
    ref_json = json.loads(capsys.readouterr().out)
    assert main(["--json", "--bench", str(got_b), path]) == 1
    got_json = json.loads(capsys.readouterr().out)
    assert set(got_json) == set(ref_json)
    assert got_json["counts"] == ref_json["counts"]
    assert got_json["allowed_counts"] == ref_json["allowed_counts"]
    assert [set(v) for v in got_json["violations"]] == [set(v) for v in ref_json["violations"]]
    ref_rec, got_rec = json.loads(ref_b.read_text()), json.loads(got_b.read_text())
    assert set(got_rec) == set(ref_rec)
    for key in ("schema", "name", "meta", "metrics"):
        assert got_rec[key] == ref_rec[key], key
