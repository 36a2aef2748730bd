"""K8 (aniso_torch.kernels.transfer), the FMM's transfer passes, against
aniso_tpu's, in float64 on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and
the port's plain version: the up pass (P2M and M2M, aniso_tpu/fmm/apply.py:
_up_pass) on whole grids and on a rectangular block, the L2L chain with a
given T per level (:549-551) and the leaf's L2T with the near field and the
1/2pi scale (:707-711), for one mode and with a mode axis.  Tolerance 1e-13
relative: the same f64 products summed in another order.  Then the launch
plan (a pure function of the shapes; the kernels themselves run only on
the card, tests/test_torch_device.py), the static operators carried across
from JAX (convert.static_from_jax_numpy) and the np limit of the card's M2L
kernels (kernels.m2l.max_np), which TransportSolver checks before it
builds anything.
"""

import functools
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.core.geometry import make_grid as j_make_grid
from aniso_tpu.fmm import apply as j_apply
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch import convert
from aniso_torch.core.config import SolverConfig
from aniso_torch.core.geometry import make_grid
from aniso_torch.fmm import apply as t_apply
from aniso_torch.kernels import m2l, transfer
from aniso_torch.solver import operator
from aniso_torch.solver.operator import TransportSolver

F64 = torch.float64
TOL = 1e-13


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def statics(deg, np_cheb):
    """(JAX's build_fmm_static in f64, the port's on the CPU)."""
    jg, tg = j_make_grid(8, deg), make_grid(8, deg)
    return (j_apply.build_fmm_static(jg, np_cheb, jnp.float64),
            t_apply.build_fmm_static(tg, np_cheb, "cpu", F64))


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("deg", [1, 2, 3])
@pytest.mark.parametrize("sz,np_cheb", [(8, 2), (16, 3), (32, 4), (32, 5)])
def test_up_pass_plain_matches_jax(sz, np_cheb, deg):
    js, ts = statics(deg, np_cheb)
    leaf = int(math.log2(sz))
    u = normal((sz, sz, (deg * deg)), 100 * sz + 10 * np_cheb + deg)
    want = j_apply._up_pass(js, leaf, jnp.asarray(u))
    got = t_apply._up_pass(ts, leaf, torch.as_tensor(u))
    assert sorted(got) == sorted(want) == list(range(2, leaf + 1))
    for level in want:
        assert rel(got[level], want[level]) < TOL


def test_up_pass_on_a_rectangular_block_is_the_whole_grids_rows():
    """A 16 x 8 block of a 32^2 grid (a shard's) up to level 2 of its own
    boxes: the same values as the whole grid's up pass at those boxes."""
    _, ts = statics(3, 4)
    u = torch.as_tensor(normal((32, 32, 9), 7))
    whole = t_apply._up_pass(ts, 5, u)
    x0, y0 = 16, 8
    block = t_apply._up_pass(ts, 5, u[x0:x0 + 16, y0:y0 + 8].contiguous(),
                             stop=2)
    assert sorted(block) == [2, 3, 4, 5]
    for level, M in block.items():
        s = 5 - level
        assert M.shape == (16 >> s, 8 >> s, 16)
        assert torch.equal(M, whole[level][x0 >> s:(x0 >> s) + (16 >> s),
                                           y0 >> s:(y0 >> s) + (8 >> s)])


def jax_l2l_chain(m2m, L, Ts):
    """aniso_tpu apply.py:549-551, one mode."""
    for T in Ts:
        m2, r = L.shape[0], L.shape[-1]
        Lc = jnp.einsum("hgac,xya->xhygc", m2m, L,
                        precision="highest")
        L = Lc.reshape(2 * m2, 2 * m2, r) + T
    return L


@pytest.mark.parametrize("D", [None, 3])
def test_l2l_chain_plain_matches_jax(D):
    """Levels 2-5 of a 32^2 grid at np 4, a given T per level."""
    js, ts = statics(3, 4)
    lead = () if D is None else (D,)
    L0 = normal(lead + (4, 4, 16), 1)
    Ts = [normal(lead + (4 << j, 4 << j, 16), 2 + j) for j in range(1, 4)]
    got = transfer.down(ts["m2m_1d"], torch.as_tensor(L0),
                        [torch.as_tensor(T) for T in Ts])
    for d in range(D or 1):
        pick = (lambda a: a) if D is None else (lambda a: a[d])
        want = jax_l2l_chain(js["m2m"], jnp.asarray(pick(L0)),
                             [jnp.asarray(pick(T)) for T in Ts])
        assert rel(pick(got.numpy()), want) < TOL


@pytest.mark.parametrize("D", [None, 3])
def test_l2t_near_and_scale_plain_match_jax(D):
    """The leaf epilogue alone (no level to L2L) and after two levels: far
    field, near add, 1/2pi (aniso_tpu apply.py:707-711)."""
    js, ts = statics(3, 4)
    lead = () if D is None else (D,)
    for n in (0, 2):
        L0 = normal(lead + (16 >> n, 16 >> n, 16), 3 + n)
        Ts = [normal(lead + (16 >> (n - j), 16 >> (n - j), 16), 5 + j)
              for j in range(1, n + 1)]
        near = normal(lead + (16, 16, 9), 9)
        got = transfer.down(ts["m2m_1d"], torch.as_tensor(L0),
                            [torch.as_tensor(T) for T in Ts], ts["l2t"],
                            torch.as_tensor(near))
        for d in range(D or 1):
            pick = (lambda a: a) if D is None else (lambda a: a[d])
            L = jax_l2l_chain(js["m2m"], jnp.asarray(pick(L0)),
                              [jnp.asarray(pick(T)) for T in Ts])
            far = jnp.einsum("kc,ijc->ijk", js["l2t"], L,
                             precision="highest")
            want = (far + jnp.asarray(pick(near))) / (2.0 * jnp.pi)
            assert rel(pick(got.numpy()), want) < TOL


def up_coverage(p, lx, ly, n):
    """How many times the up pass's launch p forms each box of each
    offset s = 0..n above an (lx, ly) plane: a block its tile's boxes up
    to offset t, then, above, the last of each parent's four children,
    which takes the parent's ticket.  Returns the counts by offset and the
    children each ticket counts."""
    cnt = [np.zeros((lx >> s, ly >> s), dtype=int) for s in range(n + 1)]
    for bx in range(p.gx):
        for by in range(p.gy):
            for s in range(p.t + 1):
                w = 1 << (p.t - s)
                cnt[s][bx * w:(bx + 1) * w, by * w:(by + 1) * w] += 1
    children = []
    for s in range(p.t + 1, n + 1):
        kids = np.zeros((lx >> s, ly >> s), dtype=int)
        for x in range(lx >> (s - 1)):
            for y in range(ly >> (s - 1)):
                kids[x >> 1, y >> 1] += 1
        cnt[s] += kids > 0
        children.append(kids)
    return cnt, children


def down_coverage(p, lx, ly, n):
    """How many blocks of the down pass's launch p form each box of each
    offset s = 0..n: the block of a tile forms its ancestors along its one
    path from offset n to offset t, then its subtree, whose leaves it
    finishes (epilogue)."""
    cnt = [np.zeros((lx >> s, ly >> s), dtype=int) for s in range(n + 1)]
    for bx in range(p.gx):
        for by in range(p.gy):
            for s in range(p.t, n + 1):
                cnt[s][bx >> (s - p.t), by >> (s - p.t)] += 1
            for s in range(p.t):
                w = 1 << (p.t - s)
                cnt[s][bx * w:(bx + 1) * w, by * w:(by + 1) * w] += 1
    return cnt


# extents of chip_smoke.py's phases and of the card tests: bench / oracle64
# (64^2), oracle128, 512^2 (also the (2, 3) mesh, on which 512^2 lives
# whole), a sharded512 shard (256 x 128), the (1, 8) mesh's blocks at 512^2
# (512 x 64, up to level 3) and at 32^2 (32 x 4, up to level 3), the
# rectangles of the card tests (192 x 64), np6 (32^2), np16 (8^2, 16^2) and
# the card test's np 22 (8^2)
EXTENTS = [(64, 64, 4), (128, 128, 5), (512, 512, 7), (256, 128, 7),
           (512, 64, 6), (32, 4, 2), (192, 64, 6), (32, 32, 3), (16, 16, 2),
           (8, 8, 1), (16, 8, 0)]
NPS = [2, 3, 4, 5, 6, 7, 16, 22, 32]


def plan_cases():
    """(lx, ly, n, r, item): every extent at np 2-7, the small grids (at
    most 64^2 squares) at np 16, 22 and 32, in float32 and float64."""
    for lx, ly, n in EXTENTS:
        for np_cheb in NPS:
            if np_cheb > 7 and lx * ly > 64 * 64:
                continue
            for item in (4, 8):
                yield lx, ly, n, np_cheb * np_cheb, item


@pytest.mark.parametrize("lx,ly,n,r,item", list(plan_cases()))
def test_launch_plan_covers_every_box_once(lx, ly, n, r, item):
    """One launch a pass; the up pass's blocks and tickets form every box
    of every level once, each ticket counting four children; the down
    pass's blocks form each leaf once and each coarser box once a block
    beneath it; each launch fits a block's shared memory; a tile spans
    more than one box only where MIN_BLOCKS blocks remain."""
    nq = 9
    for D in (1, 9):
        (up,) = transfer.up_plan(lx, ly, n, r, nq, item)
        (dn,) = transfer.down_plan(lx, ly, n, r, nq, item, D)
        for p, blocks in ((up, up.gx * up.gy), (dn, dn.gx * dn.gy * D)):
            assert 0 <= p.t <= min(n, transfer.MAX_T)
            assert (p.gx << p.t, p.gy << p.t) == (lx, ly)
            assert p.blocks == blocks
            assert p.t == 0 or blocks >= transfer.MIN_BLOCKS
            assert p.smem <= transfer.SMEM_BLOCK
        cnt, children = up_coverage(up, lx, ly, n)
        assert all((c == 1).all() for c in cnt)
        assert all((k == 4).all() for k in children)
        assert up.tickets == sum(k.size for k in children)
        assert up.tickets <= transfer.TICKETS
        for s, c in enumerate(down_coverage(dn, lx, ly, n)):
            assert (c == (4 ** (s - dn.t) if s > dn.t else 1)).all()
    assert up.smem == transfer.smem_bytes(False, up.t, r, nq, item,
                                          up.staged)
    assert dn.smem == transfer.smem_bytes(True, dn.t, r, nq, item, dn.staged,
                                          n)
    # from a level's M (up_from) and without the epilogue: nq = 0
    for p in (transfer.up_plan(lx, ly, n, r, 0, item)
              + transfer.down_plan(lx, ly, n, r, 0, item)):
        assert not p.staged and p.smem <= transfer.SMEM_BLOCK
    assert len(transfer.up_plan(lx, ly, n, r, 0, item)) == (n > 0)


def test_launch_plan_is_cached_and_splits_large_r():
    """The plan is a cached pure function; at np 4 bench's 64^2 pass has at
    least as many blocks as the card has SMs (132), tiles of 4 x 4 boxes
    there and of 8 x 8 at 512^2; a large r takes smaller tiles (in float64
    np 16 4 x 4, np 32 2 x 2) and reads the weights p2m_w / l2t in place
    where they do not fit beside it (nq 144: deg 12); a plane that 2^n does
    not divide raises."""
    assert transfer.up_plan(256, 256, 6, 16, 9, 8)[0].t == 3
    assert transfer.up_plan(256, 256, 6, 256, 9, 8)[0].t == 2
    assert transfer.up_plan(256, 256, 6, 1024, 9, 8)[0].t == 1
    for np_cheb, item in ((4, 4), (4, 8), (16, 4), (16, 8), (32, 8),
                          (46, 4)):
        _plan_is_cached_and_splits(np_cheb * np_cheb, item)


def _plan_is_cached_and_splits(r, item):
    up = transfer.up_plan(64, 64, 4, r, 9, item)
    assert up is transfer.up_plan(64, 64, 4, r, 9, item)
    assert transfer.down_plan(64, 64, 4, r, 9, item) is \
        transfer.down_plan(64, 64, 4, r, 9, item)
    if r == 16:
        assert up[0].t == 2 and up[0].blocks == 256 >= 132
        assert transfer.up_plan(512, 512, 7, r, 9, item)[0].t == 3
        assert transfer.down_plan(64, 64, 4, r, 9, item)[0].blocks >= 132
        assert transfer.up_plan(64, 64, 4, r, 9, item)[0].staged
    (big,) = transfer.up_plan(8, 8, 1, r, 144, item)
    assert big.smem <= transfer.SMEM_BLOCK
    assert big.staged == (transfer.smem_bytes(False, big.t, r, 144, item,
                                              True) <= transfer.SMEM_BLOCK)
    with pytest.raises(ValueError):
        transfer.up_plan(48, 64, 5, r, 9, item)
    with pytest.raises(ValueError):
        transfer.down_plan(64, 64, transfer.MAX_LEVELS, r, 9, item)


@pytest.mark.parametrize("np_cheb", [2, 3, 4, 5, 6, 7, 16])
def test_m2m_is_the_tensor_product_of_the_1d_transfer(np_cheb):
    """The port's static carries m2m_1d (2, np, np); its tensor product is
    JAX's m2m (aniso_tpu/fmm/cheb.py:m2m_tensor) to 1e-15, and the port's
    two 1-D products (the plain M2M and L2L) equal JAX's einsums with m2m
    to 1e-13."""
    from aniso_tpu.fmm import cheb as j_cheb

    from aniso_torch.fmm.cheb import m2m_from_1d

    tc = t_apply.build_fmm_static(make_grid(8, 1), np_cheb, "cpu",
                                  F64)["m2m_1d"].numpy()
    m2m = np.asarray(j_cheb.m2m_tensor(np_cheb))
    assert tc.shape == (2, np_cheb, np_cheb)
    assert np.abs(m2m_from_1d(tc) - m2m).max() <= 1e-15 * np.abs(m2m).max()
    r = np_cheb * np_cheb
    child = normal((4, 2, r), np_cheb)
    got = transfer.up_from_plain(torch.as_tensor(tc), torch.as_tensor(child),
                                 1)[1]
    c4 = jnp.asarray(child).reshape(2, 2, 1, 2, r)
    want = jnp.einsum("hgac,xhygc->xya", jnp.asarray(m2m), c4,
                      precision="highest")
    assert rel(got.numpy(), want) < TOL
    T = normal((2, 2, r), np_cheb + 1)
    assert rel(transfer.down_plain(torch.as_tensor(tc),
                                   torch.as_tensor(child[:1, :1]),
                                   [torch.as_tensor(T)]),
               jax_l2l_chain(jnp.asarray(m2m), jnp.asarray(child[:1, :1]),
                             [jnp.asarray(T)])) < TOL


@functools.lru_cache(maxsize=None)
def jax_solver():
    kw = dict(domain_size=16, quad_rule=2, kernel_size=1, g=0.9, sing_rule=8,
              np_cheb=3, dtype="float64")
    js = JSolver(JConfig(**kw), backend="fmm")
    s = 8 * 0.5 * (1 - np.cos(2 * np.pi * js.grid.nodes_x))
    js.set_coeff(s, s + 0.2)
    ts = TransportSolver(SolverConfig(**kw), backend="fmm", device="cpu")
    ts.set_coeff(s, s + 0.2)
    return js, ts


def test_static_from_jax_equals_the_ports_own():
    js, ts = jax_solver()
    got = convert.static_from_jax_numpy(
        {k: np.asarray(v) for k, v in js._fmm_static.items()}, "cpu", F64)
    assert sorted(got) == sorted(ts._fmm_static)
    for key in ("p2m_w", "l2t", "m2m_1d"):
        assert rel(got[key], ts._fmm_static[key]) < 1e-15
    # JAX's m2m is refused where it is not the 1-D factor's product
    bad = {k: np.asarray(v) for k, v in js._fmm_static.items()}
    bad["m2m"] = bad["m2m"] * 1.001
    with pytest.raises(ValueError, match="tensor product"):
        convert.static_from_jax_numpy(bad, "cpu", F64)
    assert torch.equal(got["shift"], ts._fmm_static["shift"])


def test_sweep_on_jax_statics_matches_jax():
    """The port's caches and tables with JAX's static operators: the
    corrected matvec equals JAX's to 1e-12 (the whole sweep's f64 sums)."""
    js, ts = jax_solver()
    static = convert.static_from_jax_numpy(
        {k: np.asarray(v) for k, v in js._fmm_static.items()}, "cpu", F64)
    u = normal((16, 16, 4), 21)
    got = t_apply.fmm_apply_mode(ts._tcfg.leaf_level, static, ts._caches,
                                 ts._mode_statics[0], 0, torch.as_tensor(u))
    want = np.asarray(js.apply_mode(0, jnp.asarray(u)))
    assert rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("item,limit", [(8, 32), (4, 46)])
def test_np_limit_of_the_m2l_kernels(item, limit):
    """The largest np whose row of 27 np^2 values the one-mode K1 plan,
    K1-D's runtime-r instance (one row of sources) and K3 (which shares
    K1's bound) take in opt-in shared memory; one more is refused."""
    dtype = torch.float64 if item == 8 else torch.float32
    assert m2l.max_np(item) == limit
    r = limit * limit
    assert 27 * r * item <= m2l.MAX_ROW_BYTES < m2l.SMEM_BLOCK
    assert m2l.plan_one(2, 2, r, item).smem <= m2l.SMEM_BLOCK
    assert transfer.up_plan(8, 8, 1, r, 9, item)[0].smem <= m2l.SMEM_BLOCK
    assert transfer.down_plan(8, 8, 1, r, 9, item, 9)[0].smem \
        <= m2l.SMEM_BLOCK
    m2l.check_np(limit, dtype)
    with pytest.raises(ValueError, match=f"np up to {limit}"):
        m2l.check_np(limit + 1, dtype)
    with pytest.raises(ValueError):
        m2l.plan_one(2, 2, (limit + 1) ** 2, item)


@pytest.mark.parametrize("dtype,refine", [("float64", False),
                                          ("float32", True)])
def test_solver_refuses_np_beyond_the_limit_before_building(monkeypatch,
                                                            dtype, refine):
    """On a CUDA device TransportSolver raises for np 33 in float64 (or
    float32 refined: its f64 twin) in its constructor, before any table
    or cache; np 32 passes that check."""
    monkeypatch.setattr(operator, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    built = []
    monkeypatch.setattr(TransportSolver, "_init_fmm",
                        lambda self, near: built.append(1))
    monkeypatch.setattr(operator, "build_near_stencil",
                        lambda *a, **k: built.append(1) or (None, None))
    monkeypatch.setattr(TransportSolver, "_couplings",
                        lambda self, dt: (None, None))

    def cfg(np_cheb):
        return SolverConfig(domain_size=8, quad_rule=1, kernel_size=1,
                            g=0.5, sing_rule=4, np_cheb=np_cheb, dtype=dtype,
                            refine=refine)

    with pytest.raises(ValueError, match="np up to 32"):
        TransportSolver(cfg(33), backend="fmm")
    assert not built
    TransportSolver(cfg(32), backend="fmm")
    assert built


def test_shared_memory_limits_agree_with_the_cuda_header():
    """csrc/smem_limits.cuh, which K1, K3 and K8 include, states the same
    block maximum and row limit as kernels/m2l.py, which plans their
    launches; K8's plan uses the same block maximum."""
    csrc = pathlib.Path(m2l.__file__).parent.parent / "csrc"
    text = (csrc / "smem_limits.cuh").read_text()
    block = re.search(r"kSmemBlock = (\d+) \* 1024;", text)
    row = re.search(r"kMaxRowBytes = kSmemBlock - (\d+);", text)
    assert int(block.group(1)) * 1024 == m2l.SMEM_BLOCK == transfer.SMEM_BLOCK
    assert m2l.SMEM_BLOCK - int(row.group(1)) == m2l.MAX_ROW_BYTES
