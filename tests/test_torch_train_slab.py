"""The port's differentiable slab_edge_max against the JAX custom VJP.

The same numpy inputs go through JAX ``slab_edge_max_train`` (Pallas
forward and backward kernels in interpret mode on the CPU, as the JAX
package's own tests run them) and the port's ``slab_edge_max_train`` (on
CPU tensors: the plain forward and the plain backward), and the
gradients of ``sum(out * cot)`` with respect to both tables and every
chain weight and bias are compared, in f32, for a 3-layer level-0-like
call and a 1-layer level-1-like call, and for a call whose duplicated
candidate row forces exact ties at the max.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.nn import pallas_kernels as pk
from pointgnn_tpu_torch.nn import slab

G, R, BK = 8, 1.5, 32


def _case(level, seed, dup_row=None):
    """Inputs of one call: (A, src4, B, ctr4, offsets, ctr_cell, tail).

    ``dup_row``: that candidate row is duplicated (same coordinates,
    same table row, raised so that it wins channels), so both copies
    tie exactly wherever one of them is a channel's max."""
    rng = np.random.default_rng(seed)
    if level == 0:
        p, k, widths = 384, 128, [16, 16, 24, 32]
    else:
        p, k, widths = 192, 192, [24, 24]
    xyz = np.stack([rng.uniform(0, 11, p), rng.uniform(-1, 1, p),
                    rng.uniform(0, 11, p)], 1).astype(np.float32)
    xyz[:4, 1] = 40.0 + np.arange(4) * 10  # isolated points
    h = widths[0]
    a = rng.normal(size=(p, h)).astype(np.float32)
    if dup_row is not None:
        xyz[dup_row + 1] = xyz[dup_row]
        a[dup_row] += 3.0
        a[dup_row + 1] = a[dup_row]
    valid = np.ones(p, bool)
    valid[p - 12:] = False
    cx = np.clip((xyz[:, 0] // R).astype(int), 0, G - 1)
    cz = np.clip((xyz[:, 2] // R).astype(int), 0, G - 1)
    cell = np.where(valid, cx * G + cz, G * G)
    order = np.argsort(cell, kind="stable")
    xyz, cell, valid, a = xyz[order], cell[order], valid[order], a[order]
    offsets = np.searchsorted(cell, np.arange(G * G + 1)).astype(np.int32)
    if level == 0:
        kidx = np.sort(rng.choice(p - 12, k, replace=False))
        kxyz, kvalid = xyz[kidx], valid[kidx].copy()
        kvalid[k - 8:] = False
        kcell = np.where(kvalid, cell[kidx], G * G).astype(np.int32)
    else:
        kxyz, kvalid, kcell = xyz, valid, cell.astype(np.int32)
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
    cot = rng.normal(size=(k, widths[-1])).astype(np.float32)
    dup = None
    if dup_row is not None:
        dup = np.flatnonzero(np.all(src4 == src4[np.argsort(order)[dup_row]],
                                    axis=1))
    return a, src4, b, ctr4, offsets, kcell, tail, cot, dup


def _grads_jax(case):
    a, src4, b, ctr4, offsets, kcell, tail, cot, _ = case
    consts = [jnp.asarray(x) for x in (src4, ctr4, offsets, kcell, cot)]

    def loss(a, b, flat):
        src4j, ctr4j, offs, cellj, cotj = consts
        out = pk.slab_edge_max_train(
            a, src4j, b, ctr4j, offs, cellj, tuple(flat), grid_g=G,
            radius=R, block_centers=BK, interpret=True,
            compute_dtype="float32", zscan="precomp",
        )
        return jnp.sum(out * cotj), out

    flat = [jnp.asarray(t) for wb in tail for t in wb]
    (_, out), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True
    )(jnp.asarray(a), jnp.asarray(b), flat)
    d_a, d_b, d_flat = jax.device_get(grads)
    return np.asarray(out), [np.asarray(d_a), np.asarray(d_b)] + [
        np.asarray(t) for t in d_flat
    ]


def _grads_port(case):
    a, src4, b, ctr4, offsets, kcell, tail, cot, _ = case
    t = torch.from_numpy
    ta = t(a).requires_grad_()
    tb = t(b).requires_grad_()
    weights = [(t(w).requires_grad_(), t(bb).requires_grad_())
               for w, bb in tail]
    out = slab.slab_edge_max_train(
        ta, t(src4), tb, t(ctr4), t(offsets), t(kcell), weights,
        grid_g=G, radius=R, compute_dtype="float32", block_centers=BK,
    )
    (out * t(cot)).sum().backward()
    grads = [ta.grad, tb.grad] + [x.grad for wb in weights for x in wb]
    return out.detach().numpy(), [gr.numpy() for gr in grads]


def _names(case):
    n = len(case[6])
    return ["d_table_a", "d_table_b"] + [
        "d_%s%d" % (kind, i) for i in range(n) for kind in ("w", "b")
    ]


# f32 on both sides: the recomputed chain agrees to a few ulps, so the
# winners agree, and the gradient sums differ only in their order
# (products of order 1 summed over <= a few hundred pairs).
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("level", [0, 1])
def test_backward_reference_matches_jax(level):
    case = _case(level, seed=10 + level)
    out_j, grads_j = _grads_jax(case)
    out_t, grads_t = _grads_port(case)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    for name, gt, gj in zip(_names(case), grads_t, grads_j):
        assert gt.shape == gj.shape, name
        np.testing.assert_allclose(gt, gj, err_msg=name, **TOL)
        assert np.abs(gj).max() > 0, name
    # structure gets no gradient: pad rows and isolated sources stay 0
    src4 = case[1]
    pad = src4[:, 0] >= 1e5
    assert (grads_t[0][pad] == 0).all()


def test_backward_reference_ties_get_full_cotangent():
    """A duplicated candidate row ties exactly with its copy wherever it
    wins a channel: both copies get the full cotangent (the JAX kernel's
    rule; torch.amax's autograd would split it)."""
    case = _case(0, seed=3, dup_row=200)
    dup = case[-1]
    assert len(dup) == 2
    out_j, grads_j = _grads_jax(case)
    out_t, grads_t = _grads_port(case)
    d_a = grads_t[0]
    assert np.abs(d_a[dup[0]]).max() > 0
    np.testing.assert_array_equal(d_a[dup[0]], d_a[dup[1]])
    for name, gt, gj in zip(_names(case), grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, err_msg=name, **TOL)


def test_backward_rejects_bad_cotangent():
    a, src4, b, ctr4, offsets, kcell, tail, cot, _ = _case(1, seed=5)
    t = torch.from_numpy
    w = [(t(w_), t(b_)) for w_, b_ in tail]
    out = slab.slab_edge_max(t(a), t(src4), t(b), t(ctr4), t(offsets),
                             t(kcell), w, G, R, compute_dtype="float32")
    with pytest.raises(ValueError, match="g must be"):
        slab.slab_edge_max_backward(
            t(a), t(src4), t(b), t(ctr4), t(offsets), t(kcell), w, out,
            t(cot[:, :3].copy()), G, R, compute_dtype="float32",
        )
