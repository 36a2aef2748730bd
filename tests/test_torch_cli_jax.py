"""aniso_torch's CLI and IO against aniso_tpu's, on the CPU, split from
test_torch_cli.py (whose data.cfg fixture they use) so that the test
workers start them after the files with more cases.

`run --device cpu` on an 8^2 data.cfg with each backend: the x it writes
matches the JAX CLI's (run in-process, its dense backend on JAX's pure line
integral: the reference's native library's build races between test
workers) to 1e-10, result.csv and points.csv are byte for byte what JAX's
writers give for the same values, and a second run warm-starts from
result.csv.  The IO writers and readers and the profiler's report against
JAX's.
"""

import os

import numpy as np
import pytest

import aniso_tpu.native
from aniso_tpu import cli as j_cli
from aniso_tpu.utils import io as j_io

from aniso_torch import cli
from aniso_torch.utils import io

from test_torch_cli import cfg_path  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def iterations(out: str) -> int:
    line = [ln for ln in out.splitlines() if ln.startswith("GMRES ")][-1]
    return int(line.rsplit("iters=", 1)[1])


@pytest.mark.parametrize("backend", ["dense", "fmm"])
def test_run_matches_jax_cli(backend, cfg_path, tmp_path, capsys,
                             monkeypatch):
    res, pts = str(tmp_path / "result.csv"), str(tmp_path / "points.csv")
    args = ["run", cfg_path, "--backend", backend, "--points", pts,
            "--result", res]
    assert cli.main(args + ["--device", "cpu"]) == 0
    cold = iterations(capsys.readouterr().out)
    x = np.loadtxt(res)
    assert x.shape == (8 * 8 * 9,) and np.isfinite(x).all()

    monkeypatch.setattr(aniso_tpu.native, "available", lambda: False)
    jres, jpts = str(tmp_path / "j_result.csv"), str(tmp_path / "j_pts.csv")
    assert j_cli.main(["run", cfg_path, "--backend", backend, "--points",
                       jpts, "--result", jres]) == 0
    assert iterations(capsys.readouterr().out) == cold
    want = np.loadtxt(jres)
    assert np.abs(x - want).max() / np.abs(want).max() < 1e-10

    # the files, byte for byte, as JAX's writers give them for these values
    again = str(tmp_path / "again.csv")
    j_io.write_result_csv(x, again)
    with open(res, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    with open(pts, "rb") as a, open(jpts, "rb") as b:
        assert a.read() == b.read()

    # warm start from result.csv
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert iterations(capsys.readouterr().out) <= 1


def test_io_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(50)
    xs, ys = rng.random((2, 50))
    for mod in (io, j_io):
        mod.write_result_csv(x, str(tmp_path / f"{mod.__name__}.r"))
        mod.write_points_csv(xs, ys, str(tmp_path / f"{mod.__name__}.p"))
    for ext in ("r", "p"):
        with open(tmp_path / f"{io.__name__}.{ext}", "rb") as a, \
                open(tmp_path / f"{j_io.__name__}.{ext}", "rb") as b:
            assert a.read() == b.read()
    got = io.load_result_csv(str(tmp_path / f"{io.__name__}.r"), n=50)
    assert np.array_equal(got, x)
    assert io.load_result_csv(str(tmp_path / "absent.csv")) is None
    with pytest.raises(ValueError):
        io.load_result_csv(str(tmp_path / f"{io.__name__}.r"), n=49)
    assert not os.path.exists(tmp_path / "absent.csv")


def test_profiler_report_matches_jax():
    """The port's Profiler keeps the reference's tic/toc semantics and
    prints JAX's table for the same section times."""
    from aniso_tpu.utils.profiler import Profiler as JProfiler
    from aniso_torch.utils.profiler import Profiler, timed

    profs = [Profiler(), JProfiler()]
    for p in profs:
        p.tic("setup")
        p.tic("ignored while clocking")
        p.toc()
        p.tic("solve")
        p.toc(count=False)
        p._times = {"setup": 1.25, "solve": 0.5}
        p._total = 1.25
    assert profs[0].report() == profs[1].report()
    assert "[U]" in profs[0].report().splitlines()[1]
    median, samples = timed(lambda: None, reps=3)
    assert len(samples) == 3 and median == sorted(samples)[1]
