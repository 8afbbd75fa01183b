"""The general generator of LiDAR serving traffic.

A traffic mix (``traffic/<mix>.json``) gives a pool size and the ranges
of the frame parameters.  Every seed gets the same pairs of
``points_per_beam`` and ``n_cars``, spread evenly over their ranges, in
an order and with frame contents drawn from the seed; so two seeds
differ in what the frames hold, not in how much work they are.
"""

import numpy as np

from benchmark.frozen.synthetic import synthetic_lidar_frame


def frame_plan(mix, seed):
    """``[(frame_seed, points_per_beam, n_cars), ...]`` of the pool."""
    n = int(mix["pool_frames"])
    lo, hi = mix["points_per_beam"]
    ppb = np.round(np.linspace(lo, hi, n)).astype(int)
    c_lo, c_hi = mix["n_cars"]
    cars = c_lo + np.arange(n) % (c_hi - c_lo + 1)
    ss = np.random.SeedSequence([int(seed) % (1 << 64), 0x9E3779B9])
    rng = np.random.default_rng(ss)
    order = rng.permutation(n)
    ppb, cars = ppb[order], cars[order]
    seeds = rng.integers(0, 2 ** 32 - 1, size=n, dtype=np.uint64)
    return [(int(s), int(p), int(c)) for s, p, c in zip(seeds, ppb, cars)]


def make_pool(mix, seed):
    """``[(xyz [N, 3] float32, attr [N, 4] float32), ...]``."""
    return [synthetic_lidar_frame(seed=s, n_beams=int(mix["n_beams"]),
                                  points_per_beam=p, n_cars=c)[:2]
            for s, p, c in frame_plan(mix, seed)]
