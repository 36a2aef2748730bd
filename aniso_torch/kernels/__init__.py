"""The port's CUDA kernels, a module each with its wrapper, its plain
PyTorch version and its launch counter."""


def launch_counters() -> list:
    """(dict, key) for every launch counter of every kernel module: what a
    captured CUDA graph's replays must add to (solver.gmres)."""
    from . import (
        attenuation, diffusion, halo, krylov, m2l, near, offsets, pcg,
        transfer,
    )

    dicts = [m.launches for m in (attenuation, diffusion, halo, krylov, m2l,
                                  near, offsets, pcg, transfer)]
    dicts.append(krylov.givens_launches)
    return [(d, key) for d in dicts for key in d]
