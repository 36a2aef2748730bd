"""K9, the DSA preconditioner's CG (aniso_torch.kernels.pcg), against the
JAX package's pcg.

On the CPU the wrapper runs its plain version: the same inputs, made from a
numpy seed, go through aniso_tpu.solver.dsa.pcg and the port's pcg at 1^2,
8^2 and 16^2 cells in f64.  x agrees to 1e-12 of its maximum (the same f64
recurrences, the stencil's adds in the same order), and the iteration count
equals the count of JAX's loop recomputed here in numpy with JAX's stencil
(JAX's pcg returns no count).  The launch plan (pcg_plan, a pure function
of the grid, the dtype, the SMs and each instance's occupancy) is held on
the CPU: the cluster instance is never chosen beyond one cluster's
capacity, a grid the register-resident instances do not hold takes the
strided one, and only an empty grid (or a card that holds no block) raises.
The tests marked `cuda` hold the three instances of the kernel (one
cluster, one cooperative grid, the strided grid) against pcg_plain on the
card (x within 1e-4 of |x| in float32 and 1e-10
in float64, the counts within 1 in float64 and 15% in float32: the same
loop, each operation rounded alike, its dot products summed in another
order, which at tol 1e-8 moves where a float32 residual below the type's
resolution crosses it), and two replays of a captured call against the
eager one, bitwise; they skip without a card and import no JAX (run them
on the card with `python -m pytest tests/test_torch_pcg.py -m cuda
--noconftest`).
"""

import numpy as np
import pytest
import torch

from aniso_torch.kernels import _cuda
from aniso_torch.kernels import pcg as k9
from aniso_torch.solver import dsa as t_dsa

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def diffusion_inputs(sz, seed):
    """A medium with sigma_t in [1, 21) and absorption in [0.1, 1.1), and
    a right-hand side, from a numpy seed."""
    rng = np.random.default_rng(seed)
    D = 0.5 / (1.0 + 20 * rng.random((sz, sz)))
    sig_a = 0.1 + rng.random((sz, sz))
    return D, sig_a, 1.0 / sz, rng.standard_normal((sz, sz))


def jax_dsa():
    """(jax.numpy, aniso_tpu.solver.dsa), imported by the CPU tests only."""
    import jax.numpy as jnp
    from aniso_tpu.solver import dsa

    return jnp, dsa


def jax_count(apply, diag, b, tol, max_iter):
    """Iterations of aniso_tpu/solver/dsa.py:pcg (:114-141) recomputed in
    numpy, the stencil JAX's own."""
    jnp, _ = jax_dsa()
    diag, b = np.asarray(diag), np.asarray(b)
    inv_diag = 1.0 / diag
    bnorm2 = np.sum(b * b)
    bnorm2 = 1.0 if bnorm2 == 0.0 else bnorm2
    x, r = np.zeros_like(b), b
    z = inv_diag * r
    p, rz = z, np.sum(r * z)
    k = 0
    while k < max_iter and np.sum(r * r) > tol * tol * bnorm2:
        ap = np.asarray(apply(jnp.asarray(p)))
        alpha = rz / np.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = np.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return k


CASES = ([(sz, tol, 500) for sz in (1, 8, 16) for tol in (1e-8, 1e-12)]
         + [(16, 1e-12, 7)])


@pytest.mark.parametrize("sz,tol,max_iter", CASES)
def test_pcg_cpu_matches_jax(sz, tol, max_iter):
    """The wrapper on CPU tensors (pcg_plain, no launch) against JAX's pcg;
    (16, 1e-12, 7) stops at max_iter."""
    jnp, j_dsa = jax_dsa()
    D, sig_a, dx, b = diffusion_inputs(sz, sz)
    j_apply, j_diag = j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    want = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b), tol=tol,
                                max_iter=max_iter))
    n0 = dict(k9.launches)
    got = k9.pcg(torch.as_tensor(b), diag, *st, tol=tol, max_iter=max_iter)
    assert k9.launches == n0
    assert got.iterations == jax_count(j_apply, j_diag, b, tol, max_iter)
    assert 0 < got.iterations <= max_iter
    assert (got.iterations == max_iter) == (max_iter == 7)
    err = np.abs(got.x.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-12


@pytest.mark.parametrize("sz", [1, 8, 16])
def test_pcg_zero_rhs_matches_jax(sz):
    """b = 0: no iteration, x = 0, as JAX (b.b taken as 1)."""
    jnp, j_dsa = jax_dsa()
    D, sig_a, dx, _ = diffusion_inputs(sz, 20 + sz)
    j_apply, j_diag = j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    b = np.zeros((sz, sz))
    got = k9.pcg(torch.as_tensor(b), diag, *st)
    want = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b)))
    assert got.iterations == 0 == jax_count(j_apply, j_diag, b, 1e-8, 500)
    assert float(got.x.abs().max()) == 0.0 == np.abs(want).max()


def test_dsa_pcg_is_the_wrapper():
    """solver.dsa.pcg on the stencil make_diffusion_apply returns is K9's
    wrapper: the same x and count, bitwise, on the CPU."""
    D, sig_a, dx, b = diffusion_inputs(8, 3)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    b = torch.as_tensor(b)
    got = t_dsa.pcg(st, diag, b, tol=1e-10, max_iter=300)
    want = k9.pcg_plain(b, diag, *st, tol=1e-10, max_iter=300)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)


def _meta(sz, dtype=torch.float64):
    def t(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    return [t((sz, sz)), t((sz, sz)), t((sz - 1, sz)), t((sz, sz - 1)),
            t((sz, sz)), t((sz, sz))]


@pytest.mark.parametrize("bad", ["diag", "Dx", "Dy", "robin", "sigma_a"])
def test_pcg_refuses_mismatched_shapes_and_dtypes(bad):
    """Off the CPU the wrapper checks every input before any launch: a
    wrong shape raises ValueError, a dtype other than b's TypeError, a
    float16 b TypeError; correct inputs off a card raise ValueError."""
    names = ["b", "diag", "Dx", "Dy", "robin", "sigma_a"]
    i = names.index(bad)
    args = _meta(8)
    args[i] = torch.empty((3, 5), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="shape"):
        k9.pcg(*args, 0.125)
    args = _meta(8)
    args[i] = args[i].float()
    with pytest.raises(TypeError):
        k9.pcg(*args, 0.125)
    with pytest.raises(TypeError):
        k9.pcg(*[a.half() for a in _meta(8)], 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        k9.pcg(*_meta(8), 0.125)


# -- the launch plan --

SMS = 132                       # an H100 SXM


def occupancy_of(cluster_blocks=16, grid_per_sm=1, strided_per_sm=None):
    """A card's occupancy for pcg_plan: clusters of up to `cluster_blocks`
    blocks schedulable (one at a time), `grid_per_sm` blocks of the grid
    instance an SM and `strided_per_sm` of the strided one (by default as
    many as of the grid instance)."""
    def occ(instance, cells, blocks, smem):
        assert cells in k9.CELLS
        if instance == "cluster":
            return int(blocks <= cluster_blocks)
        if instance == "strided":
            return grid_per_sm if strided_per_sm is None else strided_per_sm
        return grid_per_sm
    return occ


def check_plan(plan, sz, item, occ):
    """The plan's invariants: its instance holds the grid."""
    n = sz * sz
    assert plan.cells in k9.CELLS or plan.instance == "strided"
    if plan.instance == "cluster":
        assert sz <= k9.CLUSTER_MAX_SZ
        assert 1 <= plan.blocks <= k9.MAX_CLUSTER
        assert plan.rows * sz <= k9.THREADS * plan.cells
        assert plan.blocks * plan.rows >= sz > (plan.blocks - 1) * plan.rows
        assert plan.smem == k9.cluster_smem(plan.rows, sz, item)
        assert plan.smem <= k9.SMEM_BLOCK
        assert occ("cluster", plan.cells, plan.blocks, plan.smem) > 0
    elif plan.instance == "strided":
        assert plan.rows == plan.smem == 0
        per_sm = occ("strided", 1, 1, 0)
        assert 1 <= plan.blocks <= per_sm * SMS
        assert plan.blocks == per_sm * SMS or plan.blocks * k9.THREADS >= n
        assert plan.blocks * k9.THREADS * plan.cells >= n
        assert plan.blocks * k9.THREADS * (plan.cells - 1) < n
    else:
        assert plan.instance == "grid" and plan.rows == plan.smem == 0
        assert plan.blocks * k9.THREADS * plan.cells >= n
        assert (plan.blocks - 1) * k9.THREADS * plan.cells < n
        assert plan.blocks <= occ("grid", plan.cells, plan.blocks, 0) * SMS


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("sz", [1, 8, 64, 128, 256, 512])
def test_pcg_plan_never_exceeds_a_cluster(sz, item):
    """One cluster where it holds the grid up to CLUSTER_MAX_SZ (every size
    the DSA paths solve below 512^2: dsa64's 64^2 in 8 blocks, demo128's
    128^2 in 16), with the fewest cells a thread; the grid instance above
    (256^2, which a cluster of 16 would hold at 8 cells a thread, and
    512^2); and where clusters of 16 cannot be scheduled, or none at all,
    the plan takes what can."""
    occ = occupancy_of()
    plan = k9.pcg_plan(sz, item, SMS, occ)
    check_plan(plan, sz, item, occ)
    want = {1: ("cluster", 1, 1), 8: ("cluster", 1, 1),
            64: ("cluster", 1, 8), 128: ("cluster", 2, 16),
            256: ("grid", 1, 128), 512: ("grid", 4, 128)}[sz]
    assert (plan.instance, plan.cells, plan.blocks) == want
    eight = occupancy_of(cluster_blocks=8)
    plan8 = k9.pcg_plan(sz, item, SMS, eight)
    check_plan(plan8, sz, item, eight)
    if sz == 128:
        assert (plan8.instance, plan8.cells, plan8.blocks) == ("cluster", 4,
                                                               8)
    none = occupancy_of(cluster_blocks=0)
    plan0 = k9.pcg_plan(sz, item, SMS, none)
    check_plan(plan0, sz, item, none)
    assert plan0.instance == "grid"


@pytest.mark.parametrize("item", [4, 8])
def test_pcg_plan_raises_where_no_instance_holds(item):
    """Only an empty grid, or a card that holds no block of any instance,
    has no instance: 4096^2 cells, which fit no cluster and at 16 cells a
    thread more blocks than the card holds, take the strided instance, as
    512^2 does on a card that holds no block of the grid instance."""
    plan = k9.pcg_plan(4096, item, SMS, occupancy_of())
    check_plan(plan, 4096, item, occupancy_of())
    assert plan.instance == "strided"
    no_grid = occupancy_of(grid_per_sm=0, strided_per_sm=2)
    plan = k9.pcg_plan(512, item, SMS, no_grid)
    check_plan(plan, 512, item, no_grid)
    assert (plan.instance, plan.blocks, plan.cells) == ("strided", 264, 2)
    with pytest.raises(ValueError, match="no block"):
        k9.pcg_plan(4096, item, SMS, occupancy_of(grid_per_sm=0))
    with pytest.raises(ValueError):
        k9.pcg_plan(0, item, SMS, occupancy_of())


# (instance, cells a thread, blocks) on an H100 with one 512-thread block an
# SM: what 64^2, 512^2 and 1024^2 took before the strided instance, and the
# strided instance on every SM past the grid instance's 132 x 8192 cells
PLAN_SIZES = {64: ("cluster", 1, 8), 512: ("grid", 4, 128),
              1024: ("grid", 16, 128), 1040: ("strided", 17, 132),
              2048: ("strided", 63, 132), 4096: ("strided", 249, 132)}


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("sz", sorted(PLAN_SIZES))
def test_pcg_plan_takes_the_strided_instance_past_the_grid(sz, item):
    """Past the largest grid the grid instance holds at 16 cells a thread
    (1039^2 on 132 SMs) the plan takes the strided instance on every SM;
    below it exactly what it took before."""
    occ = occupancy_of()
    plan = k9.pcg_plan(sz, item, SMS, occ)
    check_plan(plan, sz, item, occ)
    assert (plan.instance, plan.cells, plan.blocks) == PLAN_SIZES[sz]


def test_pcg_cluster_smem_matches_the_source():
    """cluster_smem and the source's agree: z and the old p of the rows
    with a halo row on each side, then the ranks' partial sums."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(k9.__file__), "..", "csrc",
                            k9.SOURCE)).read()
    body = re.search(r"inline int cluster_smem\(int rows, int sz, int item\)"
                     r" \{\s*return ([^;]+);", src).group(1)
    assert body == "item * (2 * (rows + 2) * sz + 3 * kMaxCluster)"
    assert k9.cluster_smem(8, 128, 4) == 4 * (2 * 10 * 128 + 3 * 16)
    assert re.search(r"kThreads = %d;" % k9.THREADS, src)
    assert re.search(r"kMaxCluster = %d;" % k9.MAX_CLUSTER, src)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(sz, dtype, device, seed=0):
    D, sig_a, dx, b = diffusion_inputs(sz, seed)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D, dtype=dtype).to(device),
        torch.as_tensor(sig_a, dtype=dtype).to(device), dx)
    return torch.as_tensor(b, dtype=dtype).to(device), diag, st


# relative to |x|: float32 after hundreds of iterations of the same
# recurrences with dot products summed in another order; float64 to 1e-10
_X_GATE = {torch.float32: 1e-4, torch.float64: 1e-10}
# iteration counts: within 1 in float64, 15% of plain's in float32
_COUNT_GATE = {torch.float32: 0.15, torch.float64: 0.0}


def force_instance(monkeypatch, instance):
    """Make pcg plan `instance` wherever it holds the grid: the others
    reported as unschedulable."""
    def plan_on(index, sz, inst):
        real = k9._occupancy(index, inst)

        def occ(which, cells, blocks, smem):
            return real(which, cells, blocks, smem) if which == instance else 0
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        return k9.pcg_plan(sz, 4 if inst == "f32" else 8, sms, occ)
    monkeypatch.setattr(k9, "plan_on", plan_on)


# every instance where it holds the grid (no cluster holds 512^2); the
# strided instance also at 1040^2, the smallest grid it takes unforced
INSTANCE_SIZES = [(sz, inst) for sz in (8, 64, 128, 512)
                  for inst in ("cluster", "grid", "strided")
                  if not (sz == 512 and inst == "cluster")] + [
                      (1040, "strided")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz,instance", INSTANCE_SIZES)
def test_pcg_kernel_matches_plain_on_card(cuda_device, monkeypatch, dtype,
                                          sz, instance):
    """K9 in each instance (one cluster of whole rows; one cooperative grid,
    1 to 4 cells a thread at these sizes; the strided grid on every SM)
    against pcg_plain on the same card tensors at the DSA preconditioner's
    tol 1e-8 and dsa512's max_iter; the count stays on the card until
    read."""
    force_instance(monkeypatch, instance)
    b, diag, st = _card_inputs(sz, dtype, cuda_device, seed=sz)
    key = f"{instance}_{_cuda.INSTANCES[dtype]}"
    n0 = dict(k9.launches)
    got = k9.pcg(b, diag, *st, tol=1e-8, max_iter=4000)
    assert k9.launches == {**n0, key: n0[key] + 1}
    assert isinstance(got.iterations, torch.Tensor)
    assert got.iterations.device.type == "cuda"
    want = k9.pcg_plain(b, diag, *st, tol=1e-8, max_iter=4000)
    k = int(got.iterations)
    assert 0 < k < 4000
    assert abs(k - want.iterations) <= max(1, _COUNT_GATE[dtype]
                                           * want.iterations)
    err = float(torch.linalg.vector_norm(got.x - want.x)
                / torch.linalg.vector_norm(want.x))
    assert err <= _X_GATE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_kernel_stops_where_plain_does_on_card(cuda_device, dtype):
    """b = 0 takes no iteration and returns x = 0; max_iter = 7 stops at
    7."""
    b, diag, st = _card_inputs(64, dtype, cuda_device, seed=5)
    zero = k9.pcg(torch.zeros_like(b), diag, *st)
    assert int(zero.iterations) == 0 and float(zero.x.abs().max()) == 0.0
    capped = k9.pcg(b, diag, *st, tol=1e-12, max_iter=7)
    want = k9.pcg_plain(b, diag, *st, tol=1e-12, max_iter=7)
    assert int(capped.iterations) == 7 == want.iterations
    err = float(torch.linalg.vector_norm(capped.x - want.x)
                / torch.linalg.vector_norm(want.x))
    assert err <= _X_GATE[dtype]


@pytest.mark.cuda
def test_pcg_grid_too_large_raises_on_card(cuda_device, monkeypatch):
    """4096^2 cells at 16 cells a thread need more blocks of the grid
    instance than the card holds at once: a plan that asks for them is
    refused by the kernel's entry before any launch.  pcg's own plan takes
    the strided instance there and runs (500 iterations, the default
    max_iter, stop it)."""
    b, diag, st = _card_inputs(4096, torch.float32, cuda_device)
    index = cuda_device.index or 0
    assert k9.plan_on(index, 4096, "f32").instance == "strided"
    n0 = dict(k9.launches)
    got = k9.pcg(b, diag, *st)
    assert int(got.iterations) == 500
    assert bool(torch.isfinite(got.x).all())
    assert k9.launches == {**n0, "strided_f32": n0["strided_f32"] + 1}
    too_many = k9.PcgPlan("grid", 16, 4096 * 4096 // (16 * k9.THREADS), 0, 0)
    monkeypatch.setattr(k9, "plan_on", lambda *_: too_many)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k9.pcg(b, diag, *st)
    assert k9.launches == {**n0, "strided_f32": n0["strided_f32"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_strided_matches_plain_at_2048_on_card(cuda_device, dtype):
    """dsa2048's grid: the plan takes the strided instance unforced, one
    launch, and x and the count agree with pcg_plain on the DSA phases'
    medium (sigma_t 20.2, sigma_a 0.2) and a Gaussian right-hand side, at
    tol 1e-8 and max_iter 8000: x within _X_GATE of |x|, the counts within
    1% (K9 f32 counts within 15% at the smaller grids: the same gate)."""
    sz = 2048
    full = torch.full((sz, sz), 0.5 / 20.2, dtype=dtype, device=cuda_device)
    st, diag = t_dsa.make_diffusion_apply(full, 0.2 + 0 * full, 1.0 / sz)
    c = (torch.arange(sz, dtype=dtype, device=cuda_device) + 0.5) / sz - 0.5
    b = 20.0 * torch.exp(-25 * (c[:, None] ** 2 + c[None, :] ** 2))
    assert k9.plan_on(cuda_device.index or 0, sz,
                      _cuda.INSTANCES[dtype]).instance == "strided"
    key = f"strided_{_cuda.INSTANCES[dtype]}"
    n0 = dict(k9.launches)
    got = k9.pcg(b, diag, *st, tol=1e-8, max_iter=8000)
    assert k9.launches == {**n0, key: n0[key] + 1}
    want = k9.pcg_plain(b, diag, *st, tol=1e-8, max_iter=8000)
    k = int(got.iterations)
    assert 0 < k < 8000
    assert abs(k - want.iterations) <= max(1, 0.01 * want.iterations)
    err = float(torch.linalg.vector_norm(got.x - want.x)
                / torch.linalg.vector_norm(want.x))
    assert err <= _X_GATE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("sz,instance,dtype", [
    (64, "cluster", torch.float64), (64, "cluster", torch.float32),
    (128, "cluster", torch.float32), (512, "grid", torch.float32),
    (1040, "strided", torch.float32)])
def test_pcg_captured_replays_repeat_bitwise_on_card(cuda_device, sz,
                                                     instance, dtype):
    """A call captured into a CUDA graph, as the DSA step is (the cluster
    launch by cudaLaunchKernelEx, the grid and strided ones by the
    cooperative launch), at the grids and dtypes of dsa64, demo128 and
    dsa512 and the smallest strided grid, replayed twice: x and the count
    bitwise the eager call's, each replay the other's."""
    b, diag, st = _card_inputs(sz, dtype, cuda_device, seed=7)
    assert k9.plan_on(cuda_device.index or 0, sz,
                      _cuda.INSTANCES[dtype]).instance == instance
    eager = k9.pcg(b, diag, *st, tol=1e-8, max_iter=4000)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        got = k9.pcg(b, diag, *st, tol=1e-8, max_iter=4000)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        got.x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got.x, eager.x)
        assert int(got.iterations) == int(eager.iterations) > 0


@pytest.mark.cuda
def test_dsa_captured_step_replays_repeat_bitwise_on_card(cuda_device):
    """dsa64's kind of solve (64^2, f64, sigma_s 20, g 0.5) preconditioned
    by DSA: the Arnoldi step, the preconditioner's K9 (its cluster
    instance) inside, captured as a CUDA graph at the first solve and
    replayed at every step of the next two; the replayed solves' x and
    counts bitwise the first's, their K9 calls' CG iterations alike (the
    first solve also logs the eager step its capture runs)."""
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver import gmres
    from aniso_torch.solver.operator import TransportSolver

    sz = 64
    assert k9.plan_on(cuda_device.index or 0, sz, "f64").instance == \
        "cluster"
    s = TransportSolver(SolverConfig(
        domain_size=sz, quad_rule=2, kernel_size=1, g=0.5, sing_rule=6,
        np_cheb=4, dtype="float64", tol=1e-10, restart=80, max_iter=300),
        backend="fmm", device="cuda")
    g = s.grid
    sig = np.full_like(g.nodes_x, 20.0)
    s.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    pre = t_dsa.DsaPreconditioner(s)
    runs = []
    for _ in range(3):
        pre.reset()
        n0, r0 = k9.launches["cluster_f64"], gmres.stats["replays"]
        res = s.solve(q, precond=pre)
        torch.cuda.synchronize()
        runs.append((res, pre.cg_iterations, gmres.stats["replays"] - r0,
                     k9.launches["cluster_f64"] - n0))
    first = runs[0][0]
    assert first.converged
    for res, cg, replays, launched in runs[1:]:
        assert replays >= res.iterations > 0
        assert launched >= replays
        assert torch.equal(res.x, first.x)
        assert res.iterations == first.iterations
    assert runs[1][1] == runs[2][1] and max(runs[1][1]) > 0
