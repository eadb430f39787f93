"""The port's GPU CI entry (multimodalsignal_tpu_torch/gpu_ci.py) on the CPU.

The kernel tier and the bench need the card (chip_smoke.py's phase 17 runs
`python -m multimodalsignal_tpu_torch.gpu_ci` there); what runs here is the
regression gate, held against tpu_ci's on the same results and files (the
same exit code, the same written pin but for its note, the same output with
the tool's name swapped), the parsing of the bench's output, the commands
it starts, the refusal of a host without CUDA, and the flags: gpu_ci's and
the port bench's are supersets of tpu_ci.py's and bench.py's, with their
defaults.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from multimodalsignal_tpu import tpu_ci
from multimodalsignal_tpu_torch import bench, gpu_ci

REPO = Path(__file__).resolve().parents[1]
PIN = {"metric": "train steps/sec/chip", "steps_per_sec": 600.0, "tolerance": 0.05,
       "note": "an earlier pin"}
# case -> (the pin file before, or None for none; the measured value; --update-baseline)
GATE_CASES = {"missing": (None, 600.0, False), "within": (PIN, 600.0 * 0.951, False),
              "above": (PIN, 640.0, False), "regression": (PIN, 600.0 * 0.91, False),
              "update": (PIN, 650.0, True)}


def _gate(tool, case, path, capsys):
    """Run `tool`'s check_baseline on GATE_CASES[case] with the pin file at
    `path` written afresh: (rc, the pin file after, stdout)."""
    before, value, update = GATE_CASES[case]
    path.unlink(missing_ok=True)
    if before is not None:
        path.write_text(json.dumps(before))
    capsys.readouterr()
    rc = tool.check_baseline({"metric": "train steps/sec/chip", "value": value,
                              "unit": "steps/sec/chip"}, path, update)
    return rc, json.loads(path.read_text()), capsys.readouterr().out


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_agrees_with_the_jax_gate(case, tmp_path, capsys):
    path = tmp_path / "golden" / "baseline.json"
    path.parent.mkdir()
    want_rc, want_pin, want_out = _gate(tpu_ci, case, path, capsys)
    got_rc, got_pin, got_out = _gate(gpu_ci, case, path, capsys)
    assert got_rc == want_rc == {"regression": 2}.get(case, 0)
    assert {k: v for k, v in got_pin.items() if k != "note"} == \
        {k: v for k, v in want_pin.items() if k != "note"}
    assert got_out == want_out.replace("tpu_ci", "gpu_ci") and "[gpu_ci]" in got_out
    if case in ("missing", "update"):
        assert "python -m multimodalsignal_tpu_torch.gpu_ci --update-baseline" in got_pin["note"]
        assert "PERF.md" in got_pin["note"]
    else:
        assert got_pin == PIN


@pytest.mark.parametrize("value", [10.0, 600.0, 6000.0])
def test_gate_gives_no_verdict_on_another_metric(value, tmp_path, capsys):
    """A run of another dtype, shape or mode than the pin's (its metric
    string differs) is not compared with the pin, whatever its rate: exit
    1, the pin untouched, both metrics printed."""
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(PIN))
    measured = "train steps/sec/chip (float32)"
    rc = gpu_ci.check_baseline({"metric": measured, "value": value,
                                "unit": "steps/sec/chip"}, path, False)
    out = capsys.readouterr().out
    assert rc == 1 and json.loads(path.read_text()) == PIN
    assert "not compared" in out and repr(measured) in out and repr(PIN["metric"]) in out
    assert "REGRESSION" not in out and "perf OK" not in out


def test_committed_pin_names_its_card():
    """The module default is the committed pin: a positive steps/s, tpu_ci's
    tolerance, and a note naming the card it was measured on and how to
    re-pin."""
    assert gpu_ci.BASELINE == REPO / "multimodalsignal_tpu_torch" / "gpu_bench_baseline.json"
    pin = json.loads(gpu_ci.BASELINE.read_text())
    assert pin["steps_per_sec"] > 0 and pin["tolerance"] == 0.05
    assert "captured CUDA graph" in pin["metric"] and "W" in pin["note"]
    assert "--update-baseline" in pin["note"] and "PERF.md" in pin["note"]


class _Proc:
    def __init__(self, returncode=0, stdout=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, "bench's errors"


LINE_A = {"metric": "a", "value": 1.0, "unit": "steps/sec/chip", "vs_baseline": None}
LINE_B = dict(LINE_A, metric="b", value=2.5)
# case -> (exit code, stdout, the result or the SystemExit message)
BENCH_CASES = {
    "last_json_line": (0, f"bench: a card\n{json.dumps(LINE_A)}\n{json.dumps(LINE_B)}\n\n",
                       LINE_B),
    "no_json_line": (0, "bench: a card\n", "printed no JSON result line"),
    "nonzero_exit": (3, json.dumps(LINE_A) + "\n", "bench FAILED (exit 3)"),
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_run_bench_reads_the_last_json_line(case, monkeypatch, capsys):
    rc, stdout, want = BENCH_CASES[case]
    calls = []

    def run(cmd, **kwargs):
        calls.append((cmd, kwargs))
        return _Proc(rc, stdout)

    monkeypatch.setattr(gpu_ci.subprocess, "run", run)
    if isinstance(want, dict):
        assert gpu_ci.run_bench(["--steps", "100"]) == want
    else:
        with pytest.raises(SystemExit, match=re.escape(want)):
            gpu_ci.run_bench(["--steps", "100"])
    (cmd, kwargs), = calls
    assert cmd == [sys.executable, "-m", "multimodalsignal_tpu_torch.bench", "--steps", "100"]
    assert kwargs["cwd"] == REPO and kwargs["capture_output"]
    assert stdout in capsys.readouterr().out


@pytest.mark.parametrize("rc", [0, 1])
def test_kernel_tier_command(rc, monkeypatch):
    """The tier runs the CUDA tests alone, without tests/conftest.py (which
    needs JAX) and with MMS_TEST_CUDA=1; a failing tier stops the CI."""
    calls = []
    monkeypatch.setattr(gpu_ci.subprocess, "run",
                        lambda cmd, **kw: calls.append((cmd, kw)) or _Proc(rc))
    if rc:
        with pytest.raises(SystemExit, match="kernel tier FAILED"):
            gpu_ci.run_kernel_tier()
    else:
        gpu_ci.run_kernel_tier()
    (cmd, kwargs), = calls
    assert cmd == [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                   str(REPO / "tests" / "test_torch_cuda_kernels.py"), "-m", "cuda", "-q"]
    assert kwargs["env"]["MMS_TEST_CUDA"] == "1" and kwargs["cwd"] == REPO


def test_main_refuses_a_host_without_cuda(monkeypatch):
    def run(*args, **kwargs):
        raise AssertionError("nothing may run before the CUDA check")

    monkeypatch.setattr(gpu_ci.subprocess, "run", run)
    for argv in ([], ["--skip-tests"], ["--", "--steps", "10"]):
        with pytest.raises(SystemExit, match="gpu_ci must run on a CUDA host"):
            gpu_ci.main(argv)


def _jax_flags(path: Path) -> dict:
    """Option string (or a positional's name) -> (default, choices) of every
    add_argument call in a JAX-side script, read from its source; a default
    or choices that is not a literal is recorded as None."""
    flags = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            names = [ast.literal_eval(a) for a in node.args]
            kw = {k.arg: k.value for k in node.keywords}
            value = {}
            for key in ("default", "choices"):
                try:
                    value[key] = ast.literal_eval(kw[key]) if key in kw else None
                except ValueError:
                    value[key] = None
            if "action" in kw and ast.literal_eval(kw["action"]) == "store_true":
                value["default"] = False
            for name in names:
                flags[name] = (value["default"], value["choices"])
    return flags


def _port_flags(parser) -> dict:
    return {name: (a.default, a.choices)
            for a in parser._actions for name in (a.option_strings or [a.dest])}


@pytest.mark.parametrize("pair", ["bench", "ci"])
def test_flags_are_a_superset_of_the_jax_entry_points(pair):
    jax_file, port = {"bench": (REPO / "bench.py", bench.parser()),
                      "ci": (REPO / "multimodalsignal_tpu" / "tpu_ci.py", gpu_ci.parser())}[pair]
    want, got = _jax_flags(jax_file), _port_flags(port)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for name, (default, choices) in want.items():
        if default is not None:
            assert got[name][0] == default, name
        if choices is not None:
            assert set(choices) <= set(got[name][1]), name
    extra = {"bench": {"--device"}, "ci": set()}[pair]
    assert set(got) - set(want) - {"-h", "--help"} == extra


def test_gpu_ci_module_refuses_without_cuda():
    """`python -m multimodalsignal_tpu_torch.gpu_ci` exits non-zero with the
    message, before any tier or bench starts."""
    proc = subprocess.run([sys.executable, "-m", "multimodalsignal_tpu_torch.gpu_ci"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "gpu_ci must run on a CUDA host" in proc.stderr
    assert "[gpu_ci]" not in proc.stdout
