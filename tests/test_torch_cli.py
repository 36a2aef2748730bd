"""aniso_torch's CLI and IO against aniso_tpu's, on the CPU.

`run --device cpu` on an 8^2 data.cfg with each backend: the x it writes
matches the JAX CLI's (run in-process, its dense backend on JAX's pure line
integral: the reference's native library's build races between test
workers) to 1e-10, result.csv and points.csv are byte for byte what JAX's
writers give for the same values, and a second run warm-starts from
result.csv.  The checkpoint round trip, `info`, and what raises.
"""

import json
import os

import numpy as np
import pytest
import torch

import aniso_tpu.native
from aniso_tpu import cli as j_cli
from aniso_tpu.utils import io as j_io

from aniso_torch import cli
from aniso_torch.utils import io

CFG = """kernelSize = 1
g = 0.95
domainSize = 8
quadRule = 3
singRule = 8
np = 4
maxLevel = 20
Krylov = GMRES
Precdn = FFT
IO = 1
"""


@pytest.fixture
def cfg_path(tmp_path):
    path = tmp_path / "data.cfg"
    path.write_text(CFG)
    return str(path)


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


def test_checkpoint_round_trip(cfg_path, tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    res = str(tmp_path / "result.csv")
    assert cli.main(["run", cfg_path, "--device", "cpu", "--tol", "1e-8",
                     "--points", str(tmp_path / "p.csv"), "--result", res,
                     "--checkpoint", ck]) == 0
    capsys.readouterr()
    state = io.load_checkpoint(ck)
    assert state["x"].shape == (1, 8, 8, 9)
    assert np.array_equal(state["x"].reshape(-1), np.loadtxt(res))
    assert state["config"]["tol"] == 1e-8
    assert float(state["residual"]) < 1e-8
    assert cli.main(["checkpoint", ck]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["x"] == [1, 8, 8, 9] and meta["config"]["domain_size"] == 8
    assert cli.main(["checkpoint", str(tmp_path / "absent.npz")]) == 1


def test_distributed_raises(cfg_path, monkeypatch):
    """--distributed runs now (parallel.distributed); with no coordinator
    and none of torch's rendezvous environment it cannot form a group and
    raises, before any solve."""
    for var in ("ANISO_COORDINATOR", "ANISO_NUM_PROCESSES",
                "ANISO_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="env://"):
        cli.main(["run", cfg_path, "--device", "cpu", "--distributed"])


def test_distributed_one_process_matches_plain_run(cfg_path, tmp_path,
                                                    capsys):
    """--distributed with one process on a localhost coordinator (gloo on
    the CPU): the same x as the run without it, and `info` then still
    reports process 0 of 1."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    plain, dist = tmp_path / "plain.csv", tmp_path / "dist.csv"
    base = ["run", cfg_path, "--device", "cpu", "--backend", "fmm",
            "--points", str(tmp_path / "p.csv")]
    assert cli.main(base + ["--result", str(plain)]) == 0
    assert cli.main(base + ["--result", str(dist), "--distributed",
                            "--coordinator", f"127.0.0.1:{port}",
                            "--num-processes", "1", "--process-id", "0"]) == 0
    np.testing.assert_array_equal(np.loadtxt(dist), np.loadtxt(plain))
    capsys.readouterr()
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert (info["process_index"], info["process_count"]) == (0, 1)


def test_run_needs_the_card_unless_asked(cfg_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", cfg_path, "--result", str(tmp_path / "r.csv")])


def test_info_reports_cuda_devices(capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["cuda_available"] == torch.cuda.is_available()
    assert len(info["devices"]) == info["device_count"]


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


def test_compat_flag_reaches_the_solver(cfg_path, tmp_path, capsys):
    """--compat-global-basis selects the reference's basis quirk, which a
    data.cfg cannot; the banner and the checkpoint's config show it."""
    ck = str(tmp_path / "ck.npz")
    assert cli.main(["run", cfg_path, "--device", "cpu", "--tol", "1e-8",
                     "--compat-global-basis", "--checkpoint", ck,
                     "--points", str(tmp_path / "p.csv"),
                     "--result", str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert "compat_global_basis    = True" in out
    assert io.load_checkpoint(ck)["config"]["compat_global_basis"] is True


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
