"""aniso_torch.parallel.halo against aniso_tpu.parallel.halo on the CPU.

The port's halo exchange (K10's plain version on CPU shards) against JAX's
halo_exchange_1 inside shard_map on the virtual 2 x 4 mesh of
tests/conftest.py, on the same seeded block, bitwise: one square of halo
(w = 1) along x alone, along y alone and along both (the corners from the
diagonal neighbours); two boxes (w = 2), whose four parity planes are JAX's
one-box exchanges of the fine translate.  The shard-local near field
(near_apply_local, K2-S's plain version) against make_near_apply_shardmap
and the shard-local fine translate (fine_translate_local, K1-S's plain
version) against make_fine_translate_shardmap, on JAX's caches carried
across by convert, to 1e-12 relative (the same f64 sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.parallel import api as j_api
from aniso_tpu.parallel import halo as j_halo
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.convert import _m2l_level_from_jax, mode_static_from_jax_numpy
from aniso_torch.fmm.apply import parity_shift_table_np
from aniso_torch.parallel import api, halo

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

F64 = torch.float64

# torch's CPU thread pool starts here, before JAX's OpenMP host engine runs
# in this process: started after it, torch's first multi-threaded calls
# were seen to differ from its later calls on the same inputs by ~1e-9
# relative (ROADMAP queue C item 1); started first, every call agrees.
torch.exp(torch.ones(1 << 20, dtype=torch.float64)).sum()


@pytest.fixture(scope="module")
def meshes():
    """JAX's 2 x 4 mesh over the 8 virtual devices and the port's 2 x 4
    mesh of CPU shards."""
    if jax.device_count() != 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    jm = j_api.make_mesh()
    tm = api.make_mesh(devices=["cpu"] * 8)
    assert (jm.shape["x"], jm.shape["y"]) == tm.shape == (2, 4)
    return jm, tm


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def jax_exchange(jm, block, axes):
    """halo_exchange_1 along each of `axes` inside shard_map; the blocks
    extended (w = 1) come back side by side."""
    mx, my = jm.shape["x"], jm.shape["y"]

    def local(v):
        for ax in axes:
            v = j_halo.halo_exchange_1(v, ax, mx if ax == "x" else my,
                                       0 if ax == "x" else 1)
        return v

    f = jax.jit(shard_map(local, mesh=jm, in_specs=P("x", "y"),
                          out_specs=P("x", "y")))
    return np.asarray(f(jax.device_put(block, NamedSharding(jm, P("x",
                                                                   "y")))))


def unblock(parts, mesh_shape):
    """Per-shard arrays side by side along dims 0, 1 (shard order)."""
    mx, my = mesh_shape
    return np.concatenate([
        np.concatenate([np.asarray(parts[ix * my + iy]) for iy in range(my)],
                       axis=1)
        for ix in range(mx)], axis=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axes", ["x", "y", "xy"])
def test_halo_exchange_matches_jax_halo_exchange_1(meshes, axes, dtype):
    jm, tm = meshes
    block = np.random.default_rng(7).standard_normal((16, 24, 5)).astype(
        dtype)
    want = jax_exchange(jm, block, axes)
    sh = api.shard_field(tm, torch.as_tensor(block))
    ext = halo.halo_exchange(tm, sh.blocks, 1)
    # JAX's one-axis result is the port's extended block without the other
    # axis's halo
    rows = slice(None) if "x" in axes else slice(1, -1)
    cols = slice(None) if "y" in axes else slice(1, -1)
    got = unblock([e[rows, cols].numpy() for e in ext], tm.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_box_halo_is_jax_parity_plane_exchange(meshes, dtype):
    """w = 2 on the multipoles of a level: each parity plane of the
    extended block is JAX's one-box exchange of that plane (the fine
    translate's halo, aniso_tpu/parallel/halo.py:135-150)."""
    jm, tm = meshes
    M = np.random.default_rng(8).standard_normal((16, 32, 9)).astype(dtype)
    sh = api.shard_field(tm, torch.as_tensor(M))
    ext = halo.halo_exchange(tm, sh.blocks, 2)
    for gx in (0, 1):
        for gy in (0, 1):
            want = jax_exchange(jm, M[gx::2, gy::2], "xy")
            got = unblock([e[gx::2, gy::2].numpy() for e in ext], tm.shape)
            np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def jax_solver(compat):
    cfg = JConfig(domain_size=16, quad_rule=2, kernel_size=2, g=0.9,
                  sing_rule=4, np_cheb=3, dtype="float64",
                  compat_global_basis=compat)
    s = JSolver(cfg, backend="fmm")
    g = s.grid
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    return s


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
def test_near_apply_local_matches_jax_shardmap(meshes, mode, compat):
    jm, tm = meshes
    js = jax_solver(compat)
    g = js.grid
    u = np.random.default_rng(0).random((g.sz, g.sz, g.nq))
    ms = js._mode_statics[mode]
    caches = j_api.shard_pytree(jm, js._caches)
    ms_sh = j_api.shard_pytree(jm, ms)
    # under jit, as JAX's sharded_solver runs it: one compile, where the
    # eager call compiles each primitive on its own
    f = jax.jit(j_halo.make_near_apply_shardmap(jm, mode, "duffy" in ms))
    want = np.asarray(f(caches["near_E"], ms_sh["near_cosrw"],
                        ms_sh["near_static"], caches["sigma_w"],
                        ms_sh.get("duffy"),
                        j_api.shard_field(jm, jnp.asarray(u)), 0.0))

    tms = mode_static_from_jax_numpy(
        {k: v for k, v in ms.items()}, "cpu", F64)
    nE = api.shard(tm, torch.as_tensor(
        np.asarray(js._caches["near_E"]).transpose(4, 5, 2, 0, 1, 3)
        .copy()), (0, 1))
    sw = api.shard_field(tm, torch.tensor(np.asarray(
        js._caches["sigma_w"])))
    duffy = None if tms["duffy"] is None else api.shard_field(tm,
                                                              tms["duffy"])
    ue = halo.halo_exchange(tm, api.shard_field(tm, torch.as_tensor(u)).blocks,
                            1)
    got = unblock([
        halo.near_apply_local(nE.blocks[k], tms["near_cosrw"],
                              tms["near_static"], sw.blocks[k],
                              None if duffy is None else duffy.blocks[k],
                              ue[k], mode).numpy()
        for k in range(tm.size)], tm.shape)
    assert rel(got, want) < 1e-12


@pytest.mark.parametrize("level", [3, 4])
def test_fine_translate_local_matches_jax_shardmap(meshes, level):
    """Both fine dense levels of the 16^2 tree (B = 2 and the leaf)."""
    jm, tm = meshes
    js = jax_solver(False)
    E4 = js._caches["m2l_E"][level]
    assert isinstance(E4, tuple) and E4[0].ndim == 4     # row-major blocks
    cosr = js._mode_statics[0]["m2l_cosr"][level]
    m = 1 << level
    M = np.random.default_rng(level).standard_normal((m, m, 9))
    E4_sh = j_api.shard_pytree(jm, {"m2l_E": {level: E4}})["m2l_E"][level]
    f = jax.jit(j_halo.make_fine_translate_shardmap(jm, "row"))
    want = np.asarray(f(E4_sh, j_api.replicate(jm, cosr),
                        j_api.shard_field(jm, jnp.asarray(M)), 0.0))

    E = api.shard(tm, torch.as_tensor(_m2l_level_from_jax(
        tuple(np.asarray(b) for b in E4))), (1, 2))
    cosr_t = torch.as_tensor(np.asarray(cosr).reshape(4, 9, 27 * 9))
    shift = torch.as_tensor(parity_shift_table_np(), dtype=torch.int32)
    ext = halo.halo_exchange(tm, api.shard_field(tm, torch.as_tensor(M))
                             .blocks, 2)
    got = unblock([
        halo.fine_translate_local(E.blocks[k], cosr_t, ext[k], shift).numpy()
        for k in range(tm.size)], tm.shape)
    assert rel(got, want) < 1e-12
