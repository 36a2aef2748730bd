"""Two processes, one mesh: aniso_torch.parallel over torch.distributed
(gloo) on the CPU.

Mirrors tests/test_distributed.py: two OS processes call
parallel.distributed.init on a localhost port, build one 2 x 2 mesh whose
shards are split across them (two each: the halos along x and the diagonal
corners cross between processes by P2P, the ones along y stay inside a
process), run one sharded corrected matvec and one sharded GMRES solve, and
the results are held against the one-process matvec and solve.  The
rendezvous's store lives in the test process, on a port the kernel picked
and that stays bound until both workers have ended, so no other process can
take it in between; every wait has a bound (JOIN_S for the join and each
collective, RUN_S for the whole pair), and a run that overruns one fails.
Without CUDA, init() with no backend (NCCL) raises and forms no group.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60     # the process-group join and each collective
RUN_S = 240     # both workers, start to end

_WORKER = r"""
import json, sys
import numpy as np
import torch
from aniso_torch.core.config import SolverConfig
from aniso_torch.parallel import distributed, halo
from aniso_torch.parallel.api import make_mesh, shard_field, sharded_solver
from aniso_torch.solver.gmres import gmres
from aniso_torch.solver.operator import TransportSolver

pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
distributed.init(f"localhost:{port}", 2, pid, backend="gloo",
                 timeout=float(sys.argv[4]))
assert distributed.is_multiprocess() and distributed.process_count() == 2

cfg = SolverConfig(domain_size=16, quad_rule=2, kernel_size=1, g=0.9,
                   sing_rule=8, np_cheb=3, dtype="float64")
s = TransportSolver(cfg, backend="fmm", device="cpu")
g = s.grid
sig = 8.0 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
s.set_coeff(sig, sig + 0.2)
q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))

mesh = make_mesh(devices=["cpu", "cpu"])   # 4 shards, 2 a process
assert mesh.shape == (2, 2) and mesh.local == [2 * pid, 2 * pid + 1]
apply_fn, caches, ms = sharded_solver(s, mesh)
halo.reset_collectives()
b = apply_fn(caches, ms[0], 0, shard_field(mesh, torch.as_tensor(q)))
matvec_stats = halo.collective_stats()
sig_sh = shard_field(mesh, s.sigma_s)
res = gmres(lambda v: v - apply_fn(caches, ms[0], 0, sig_sh * v), b,
            restart=30, max_iter=60, tol=1e-10)
b_full, x_full = b.full(), res.x.full()
if pid == 0:
    np.save(out + ".b.npy", b_full.numpy())
    np.save(out + ".x.npy", x_full.numpy())
    with open(out, "w") as f:
        json.dump({"iterations": res.iterations, "residual": res.residual,
                   "converged": res.converged,
                   "processes": distributed.process_count(),
                   "permute": matvec_stats.counts.get("permute", 0)}, f)
distributed.shutdown()
"""


def test_two_process_sharded_matvec_and_gmres(tmp_path):
    import torch.distributed as dist

    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.gmres import gmres
    from aniso_torch.solver.operator import TransportSolver

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "result.json"
    # torch's tcp:// rendezvous makes every rank a client of this store
    # under TORCHELASTIC_USE_AGENT_STORE (the elastic agent's layout)
    store = dist.TCPStore("localhost", 0, is_master=True,
                          timeout=datetime.timedelta(seconds=JOIN_S),
                          wait_for_workers=False)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               TORCHELASTIC_USE_AGENT_STORE="True")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(store.port),
             str(out), str(JOIN_S)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=RUN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=JOIN_S)
        del store
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-3000:]
    rec = json.loads(out.read_text())
    assert rec["processes"] == 2 and rec["converged"]
    assert rec["permute"] > 0

    # the one-process reference
    cfg = SolverConfig(domain_size=16, quad_rule=2, kernel_size=1, g=0.9,
                       sing_rule=8, np_cheb=3, dtype="float64")
    s = TransportSolver(cfg, backend="fmm", device="cpu")
    g = s.grid
    sig = 8.0 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    b = s.apply_mode(0, torch.as_tensor(q))
    ref = gmres(lambda v: v - s.apply_mode(0, s.sigma_s * v), b,
                restart=30, max_iter=60, tol=1e-10)
    b_dist = np.load(str(out) + ".b.npy")
    x_dist = np.load(str(out) + ".x.npy")
    np.testing.assert_allclose(b_dist, b.numpy(), rtol=1e-12, atol=1e-13)
    assert abs(rec["iterations"] - ref.iterations) <= 1
    assert rec["residual"] < 1e-10
    np.testing.assert_allclose(x_dist, ref.x.numpy(), rtol=1e-8, atol=1e-10)


def test_init_without_a_backend_needs_cuda():
    """init() with no backend takes NCCL; without CUDA it raises, naming
    the way to a CPU group, before any group forms."""
    import torch.distributed as dist

    from aniso_torch.parallel import distributed

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: init() forms an NCCL group")
    with pytest.raises(RuntimeError, match='backend="gloo".*--device cpu'):
        distributed.init("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized() and not distributed.is_initialized()
    assert distributed.process_count() == 1
