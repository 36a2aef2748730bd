"""Roofline accounting of the corrected FMM matvec on the H100.

Counterpart of aniso_tpu/utils/roofline.py.  matvec_costs counts, from the
caches that ran, the least device-memory traffic of one corrected
single-mode matvec (every resident cache byte read once: the matvec
streams its caches) and the operations of its contractions;
roofline_summary divides them by a measured matvec time.  The achieved
bandwidth, min bytes / time, is therefore a lower bound on what the card
moved, and its share of the peak a lower bound on the roofline position.

Counted in the port's own layouts (contiguous, no padding) and in the
solver's itemsize: dense M2L levels (4, m2, m2, r, 27r) read by K1,
per-offset levels {'Wo'} whose E K3 forms from the coefficient field
inside the matvec, the near E of K2, and K8's sweeps.  The operation
counts are the JAX package's formulas.  Not ported: the TPU's (8, 128)
tile padding (_nbytes_tiled), the factored {patch, W} levels and the
virtual near field (the port has neither), and the TPU v5e peaks.

Peaks: NVIDIA's H100 Tensor Core GPU data sheet, the H100 SXM (80 GB HBM3,
700 W), dense rates.  A card set below 700 W runs slower, so a share is
stated beside the card's name and power limit (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`).  Plain Python on
shapes: it launches nothing and runs the same on the CPU and the card.
"""

from __future__ import annotations

from ..fmm.smooth import _fine_offset_entries

HBM_BYTES_PER_S = 3.35e12        # device memory
# the operation bound's peaks: float32 outside the tensor cores, float64
# on the tensor cores (the card's fastest float64 rate)
PEAK_FLOP_PER_S = {"f32": 67e12, "f64": 67e12}
PEAK_NAMES = {"f32": "f32", "f64": "f64_tensor_cores"}
# float64 on the CUDA cores (scalar multiply-adds, no matrix product)
PEAK_F64_CUDA_CORES = 33.5e12


def bound_ms(nbytes, flops, inst="f32", peak=None):
    """The least time for the work, in ms: bytes at the memory rate or
    operations at the type's peak (or `peak`), whichever is longer, and
    which ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOP_PER_S[inst])
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def matvec_costs(solver) -> dict:
    """One corrected single-mode matvec of an FMM solver after set_coeff:
    min_hbm_bytes (every cache byte read once, the planes, the fields),
    transient_hbm_bytes (what the kernels write and read again: none,
    since K3 forms E in its accumulators and never writes it), flops, and
    level_repr ({"m2l_level_<l>": "dense" or "offsets"})."""
    g, tcfg, caches = solver.grid, solver._tcfg, solver._caches
    np_cheb = solver.cfg.np_cheb
    r = np_cheb * np_cheb
    P = r * 27 * r
    item = caches["sigma_w"].element_size()
    field = g.sz * g.sz * g.nq * item
    bytes_read = flops = 0
    detail = {}

    # --- M2L levels ---
    for lv, E_l in caches["m2l_E"].items():
        m2 = tcfg.boxes(lv) // 2
        if isinstance(E_l, dict):
            # per-offset (K3): one window dot per canonical (class, offset)
            # block against its offset's (r^2, K) weights, the exponential
            # on the canonical half only (shared with the mirror), the
            # contraction over all 4 x 27 blocks
            entries, keys, _ = _fine_offset_entries(np_cheb)
            B = tcfg.box_size_squares(lv)
            K = [(abs(di) + 1) * B * (abs(dj) + 1) * B * g.nq
                 for di, dj in keys]
            blk = m2 * m2 * r * r
            bytes_read += _nbytes(E_l["Wo"]) + field   # + coefficient field
            flops += sum(2 * blk * K[entry[-1]] for entry in entries)
            flops += 3 * len(entries) * blk
            flops += 2 * 4 * m2 * m2 * P
            detail[f"m2l_level_{lv}"] = "offsets"
        else:
            # dense (K1): exp(-E) * cosr (3 operations a value), then the
            # (r x 27r) @ (27r) translate of every box of every class
            bytes_read += _nbytes(E_l)
            flops += 3 * 4 * m2 * m2 * P
            flops += 2 * 4 * m2 * m2 * P
            detail[f"m2l_level_{lv}"] = "dense"
        # the level's multipole and local planes
        bytes_read += 2 * 4 * m2 * m2 * r * item

    # --- near field (K2) ---
    bytes_read += _nbytes(caches["near_E"])
    near_elems = 9 * g.nq * g.nq * g.sz * g.sz
    flops += 2 * near_elems          # block contract
    flops += 3 * near_elems          # expm1, scale, stencil add
    bytes_read += _nbytes(caches["sigma_w"])
    duffy = solver._mode_statics[0]["duffy"]
    if duffy is not None:
        bytes_read += _nbytes(duffy)
        flops += 2 * g.nq * g.nq * g.sz * g.sz

    # --- sweeps (K8: P2M, M2M, L2L, L2T) ---
    flops += 2 * 2 * g.sz * g.sz * g.nq * r          # P2M + L2T
    for lv in range(2, tcfg.leaf_level):
        m = tcfg.boxes(lv + 1)
        flops += 2 * 2 * m * m * r * r               # M2M + L2L
    bytes_read += 3 * field          # u in, out, the weights' fold

    return {
        "min_hbm_bytes": int(bytes_read),
        "transient_hbm_bytes": 0,
        "flops": int(flops),
        "level_repr": detail,
    }


def roofline_summary(solver, matvec_s: float) -> dict:
    """Roofline position of a measured matvec time (seconds) on the H100:
    matvec_costs with the achieved rates and their shares of the peaks
    (the memory rate, and the operation peak of the solver's dtype, its
    share named for it), bound_ms, the least time of the counted work,
    bound_by, which bound that is, and the peaks used."""
    c = matvec_costs(solver)
    inst = "f64" if solver._caches["sigma_w"].element_size() == 8 else "f32"
    name, flop_peak = PEAK_NAMES[inst], PEAK_FLOP_PER_S[inst]
    bytes_per_s = c["min_hbm_bytes"] / matvec_s
    incl = (c["min_hbm_bytes"] + c["transient_hbm_bytes"]) / matvec_s
    flops_per_s = c["flops"] / matvec_s
    bms, bby = bound_ms(c["min_hbm_bytes"], c["flops"], inst)
    return {
        **c,
        "matvec_ms": 1e3 * matvec_s,
        "achieved_gbps_min": bytes_per_s / 1e9,
        "achieved_gbps_incl_transients": incl / 1e9,
        "pct_hbm_peak": 100.0 * bytes_per_s / HBM_BYTES_PER_S,
        "pct_hbm_peak_incl_transients": 100.0 * incl / HBM_BYTES_PER_S,
        "achieved_tflops": flops_per_s / 1e12,
        f"pct_{name}_peak": 100.0 * flops_per_s / flop_peak,
        "bound_ms": bms,
        "bound_by": bby,
        "peaks": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                  "flop_per_s": flop_peak, "flop_peak": name},
    }
