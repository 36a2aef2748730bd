"""aniso_torch's CLI on the CPU: the checkpoint round trip, `info`,
`--compat-global-basis`, `--distributed` with one gloo process (and what it
raises without a group), and the refusal to run without a card unless
`--device cpu` asks.  The runs held against aniso_tpu's CLI and IO are in
test_torch_cli_jax.py, which takes its data.cfg from here.
"""

import json
import os

import numpy as np
import pytest
import torch

from aniso_torch import cli
from aniso_torch.utils import io

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60     # the process-group join and each collective
RUN_S = 240     # the subprocess of the --distributed run, start to end

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


# the plain run, the --distributed run and `info` in one fresh process,
# the join bounded by the timeout the CLI's init call is given here
_DIST_RUN = r"""
import functools, json, sys
from aniso_torch import cli
from aniso_torch.parallel import distributed

base, plain, dist, coordinator, join_s = json.loads(sys.argv[1])
distributed.init = functools.partial(distributed.init, timeout=join_s)
rcs = [cli.main(base + ["--result", plain]),
       cli.main(base + ["--result", dist, "--distributed", "--coordinator",
                        coordinator, "--num-processes", "1",
                        "--process-id", "0"])]
print("INFO")
rcs.append(cli.main(["info"]))
print("RCS", json.dumps(rcs))
"""


def test_distributed_one_process_matches_plain_run(cfg_path, tmp_path):
    """--distributed with one process on a localhost coordinator (gloo on
    the CPU): the same x as the run without it, and `info` then still
    reports process 0 of 1.  Run in a process of its own with a bound on
    the whole run and one of JOIN_S on the join; the rendezvous's store
    is this process's, on a port the kernel picked and that stays bound
    (every rank a client of it, as under torch's elastic agent)."""
    import datetime
    import subprocess
    import sys

    import torch.distributed as tdist

    store = tdist.TCPStore("127.0.0.1", 0, is_master=True,
                           timeout=datetime.timedelta(seconds=JOIN_S),
                           wait_for_workers=False)
    plain, dist = tmp_path / "plain.csv", tmp_path / "dist.csv"
    base = ["run", cfg_path, "--device", "cpu", "--backend", "fmm",
            "--points", str(tmp_path / "p.csv")]
    env = dict(os.environ, PYTHONPATH=ROOT,
               TORCHELASTIC_USE_AGENT_STORE="True")
    try:
        run = subprocess.run(
            [sys.executable, "-c", _DIST_RUN, json.dumps(
                [base, str(plain), str(dist), f"127.0.0.1:{store.port}",
                 JOIN_S])],
            env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=RUN_S)
    finally:
        del store
    assert run.returncode == 0, run.stderr[-3000:]
    info, rcs = run.stdout.split("\nINFO\n", 1)[1].rsplit("RCS ", 1)
    assert json.loads(rcs) == [0, 0, 0]       # plain, --distributed, info
    np.testing.assert_array_equal(np.loadtxt(dist), np.loadtxt(plain))
    info = json.loads(info)
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
