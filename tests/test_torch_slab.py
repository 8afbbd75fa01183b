"""The port's slab_edge_max against the JAX kernel.

The same numpy inputs go through JAX ``slab_edge_max`` (Pallas, in
interpret mode on the CPU) and the port's ``slab_edge_max`` (on a CPU
tensor: the plain PyTorch version), for a level-0-like call (distinct
point and center sets, 3-layer tail) and a level-1-like call (one set,
1-layer tail), both with pad rows and centers that have no neighbor.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointgnn_tpu.nn import pallas_kernels as pk
from pointgnn_tpu_torch.nn import slab

G, R, BK = 8, 1.5, 32


def _sorted_cells(xyz, valid):
    cx = np.clip((xyz[:, 0] // R).astype(int), 0, G - 1)
    cz = np.clip((xyz[:, 2] // R).astype(int), 0, G - 1)
    return np.where(valid, cx * G + cz, G * G)


def _case(level, seed):
    """Inputs of one call: (A, src4, B, ctr4, offsets, ctr_cell, tail)."""
    rng = np.random.default_rng(seed)
    if level == 0:
        p, k, widths = 512, 256, [16, 16, 24, 32]
    else:
        p, k, widths = 256, 256, [32, 32]
    xyz = np.stack([rng.uniform(0, 11, p), rng.uniform(-1, 1, p),
                    rng.uniform(0, 11, p)], 1).astype(np.float32)
    # a few isolated points: at level 1 their only neighbor is themselves
    xyz[:4, 1] = 40.0 + np.arange(4) * 10
    valid = np.ones(p, bool)
    valid[p - 20:] = False
    cell = _sorted_cells(xyz, valid)
    order = np.argsort(cell, kind="stable")
    xyz, cell, valid = xyz[order], cell[order], valid[order]
    offsets = np.searchsorted(cell, np.arange(G * G + 1)).astype(np.int32)
    if level == 0:
        kidx = np.sort(rng.choice(p - 20, k, replace=False))
        kxyz, kvalid = xyz[kidx], valid[kidx].copy()
        kvalid[k - 12:] = False
        kxyz[5:9, 1] = 50.0  # valid centers with no point in radius
        kcell = np.where(kvalid, cell[kidx], G * G).astype(np.int32)
    else:
        kxyz, kvalid, kcell = xyz, valid, cell.astype(np.int32)
    h = widths[0]
    a = rng.normal(size=(p, h)).astype(np.float32)
    b = rng.normal(size=(k, h)).astype(np.float32)
    tail = []
    for din, dout in zip(widths[:-1], widths[1:]):
        tail.append((
            (rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32),
            (rng.normal(size=(dout,)) * 0.1).astype(np.float32),
        ))
    src4 = np.concatenate([xyz, np.zeros((p, 1), np.float32)], 1)
    src4[~valid] = 1e6
    ctr4 = np.concatenate([kxyz, np.zeros((k, 1), np.float32)], 1)
    ctr4[~kvalid] = -1e6
    return a, src4, b, ctr4, offsets, kcell, tail, kvalid


def _run_both(case, compute_dtype):
    a, src4, b, ctr4, offsets, kcell, tail, _ = case
    flat = tuple(jnp.asarray(t) for wb in tail for t in wb)
    ref = np.asarray(pk.slab_edge_max(
        jnp.asarray(a), jnp.asarray(src4), jnp.asarray(b),
        jnp.asarray(ctr4), jnp.asarray(offsets), jnp.asarray(kcell), flat,
        grid_g=G, radius=R, block_centers=BK, interpret=True,
        compute_dtype=compute_dtype, zscan="precomp",
    ))
    t = torch.from_numpy
    out = slab.slab_edge_max(
        t(a), t(src4), t(b), t(ctr4), t(offsets), t(kcell),
        [(t(w), t(bb)) for w, bb in tail],
        grid_g=G, radius=R, compute_dtype=compute_dtype, block_centers=BK,
    ).numpy()
    return ref, out


# f32: both sides compute the same f32 sums in another order, so they
# agree to a few f32 ulps of values of order 1-5.  bf16: an f32 sum that
# lands on the other side of a bf16 rounding boundary moves a hidden
# activation by one bf16 ulp (2^-8 = 0.4% relative), which the next
# layers carry on; 1e-2 covers one such flip on values of order 1-5.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", [0, 1])
def test_slab_edge_max_matches_jax(level, compute_dtype):
    case = _case(level, seed=level)
    ref, out = _run_both(case, compute_dtype)
    kvalid = case[-1]
    assert out.shape == ref.shape
    assert (out[~kvalid] == 0).all()
    if level == 0:  # valid centers with no neighbor get 0 on both sides
        assert (out[5:9] == 0).all() and (ref[5:9] == 0).all()
    np.testing.assert_allclose(out, ref, **TOL[compute_dtype])


def test_column_row_windows_match_jax():
    """The port's per-(block, column) windows equal the JAX ones."""
    a, src4, b, ctr4, offsets, kcell, tail, _ = _case(0, seed=3)
    lo_j, hi_j = pk.column_row_windows(
        jnp.asarray(offsets), jnp.asarray(kcell), G, BK, 1
    )
    lo_t, hi_t = slab.column_row_windows(
        torch.from_numpy(offsets), torch.from_numpy(kcell), G, BK, 1
    )
    nb = len(kcell) // BK
    np.testing.assert_array_equal(np.asarray(lo_j)[:nb], lo_t.numpy())
    np.testing.assert_array_equal(np.asarray(hi_j)[:nb], hi_t.numpy())


def test_inradius_pair_count_is_brute_force():
    """The walked windows hold every in-radius pair exactly once."""
    a, src4, b, ctr4, offsets, kcell, tail, _ = _case(0, seed=4)
    d2 = ((ctr4[:, None, :3] - src4[None, :, :3]) ** 2).sum(-1)
    n = slab.inradius_pair_count(
        torch.from_numpy(src4), torch.from_numpy(ctr4),
        torch.from_numpy(offsets), torch.from_numpy(kcell), G, R,
    )
    assert n == int((d2 <= np.float32(R * R)).sum())


def test_slab_edge_max_rejects_bad_inputs():
    a, src4, b, ctr4, offsets, kcell, tail, _ = _case(1, seed=5)
    t = torch.from_numpy
    w = [(t(w_), t(b_)) for w_, b_ in tail]
    with pytest.raises(ValueError, match="int32"):
        slab.slab_edge_max(t(a), t(src4), t(b), t(ctr4),
                           t(offsets).long(), t(kcell), w, G, R)
    with pytest.raises(ValueError, match="src_xyz"):
        slab.slab_edge_max(t(a), t(src4[:, :3].copy()), t(b), t(ctr4),
                           t(offsets), t(kcell), w, G, R)
