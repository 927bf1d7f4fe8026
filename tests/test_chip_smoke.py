"""chip_smoke.py on the CPU: its device phase refuses a CPU-only backend, its
parity helpers agree CPU against CPU at a tiny size, and ``--four-cards``
runs the mesh phase and nothing else (on 4 of the 8 virtual CPU devices).
The ``gpu`` test runs the parity helper GPU against CPU on a card."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from gym_simpletetris_tpu import EnvConfig
from gym_simpletetris_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.check_device(1)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_script_exits_nonzero_without_gpu(where, tmp_path):
    """No result line and a non-zero exit on a CPU-only backend, whether run
    in the checkout or in a directory holding only the script."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_parity_helper_cpu_against_cpu(obs_type):
    cpus = jax.devices("cpu")
    cfg = EnvConfig(obs_type=obs_type, width=6, height=8, auto_reset=True)
    assert cs.parity_bitwise(cfg, 8, 6, cpus[0], cpus[1]) >= 0.0


def test_assert_trees_equal_names_the_differing_leaf():
    a = {"x": np.zeros(3, np.int32), "y": np.ones(2, np.uint8)}
    cs.assert_trees_equal(a, {k: v.copy() for k, v in a.items()}, "same")
    b = {"x": a["x"], "y": np.asarray([1, 0], np.uint8)}
    with pytest.raises(AssertionError, match=r"\['y'\] differs \(1"):
        cs.assert_trees_equal(a, b, "t")
    with pytest.raises(AssertionError):
        cs.assert_trees_equal(a, {"x": a["x"].astype(np.int64),
                                  "y": a["y"]}, "dtype")


def test_bf16_tolerance():
    want = np.linspace(-2.0, 2.0, 64, dtype=np.float32)
    ulp = 2.0 ** -8 * 2.0
    assert cs.bf16_close(want + 3 * ulp, want, "close") == pytest.approx(
        3.0, rel=1e-4)
    with pytest.raises(AssertionError, match="bf16 ulps"):
        cs.bf16_close(want + (cs.BF16_TOL_ULPS + 1) * ulp, want, "far")
    with pytest.raises(AssertionError, match="non-finite"):
        cs.bf16_close(np.full(64, np.nan, np.float32), want, "nan")


def test_four_cards_runs_only_the_mesh_phase(monkeypatch, capsys):
    calls = []
    real_mesh = cs.phase_mesh

    def fail(*a, **k):
        raise AssertionError("a one-card phase ran under --four-cards")

    monkeypatch.setattr(cs, "check_device", lambda count: calls.append(
        ("device", count)) or {"platform": "cpu", "kind": "cpu",
                               "count": count})
    monkeypatch.setattr(cs, "card_name_and_power", lambda: "none, 0 W")
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: "unset")
    monkeypatch.setattr(cs, "phase_parity", fail)
    monkeypatch.setattr(cs, "phase_trainers", fail)
    monkeypatch.setattr(cs, "phase_mesh", lambda n: calls.append(
        ("mesh", n)) or real_mesh(n, per_device=4, steps=3))
    cs.main(["--four-cards"])
    assert calls == [("device", 4), ("mesh", 4)]
    out = capsys.readouterr().out.strip().splitlines()
    assert "ShardedTetrisEnv" in "\n".join(out)
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 4}}


@pytest.mark.gpu
def test_gpu_matches_cpu_small(gpu_device):
    cfg = EnvConfig(obs_type="grayscale", auto_reset=True)
    cs.parity_bitwise(cfg, 256, 32, gpu_device, jax.devices("cpu")[0])
