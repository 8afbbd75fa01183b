"""The port's segment aggregations (``nn/segment.py``) against the JAX
package's: forward bitwise in f32, gradients against ``jax.grad`` at
1e-6, with ties inside a chunk and across a chunk boundary, empty
segments, the dropped sentinel segment and unsorted destinations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.nn import segment as jseg
from pointgnn_tpu_torch.nn import segment as tseg

NUM_CENTERS = 6
C = 5


def _case(seed, sorted_dst=True, ties=True):
    """[16, C] values and destinations over 6 centers: center 4 has no
    edge, three edges carry the sentinel 6, and (``ties``) center 1's
    four edges (edges 2-5) hold the same row, so 4 chunks of 4 put two
    ties in chunk 0 and two in chunk 1."""
    rng = np.random.default_rng(seed)
    dst = np.array([0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 3, 5, 5, 6, 6, 6],
                   np.int32)
    vals = rng.normal(size=(len(dst), C)).astype(np.float32)
    if ties:
        vals[3] = vals[2]
        vals[4] = vals[2]
        vals[5] = vals[2]
        vals[7, 1] = vals[6, 1]  # a tie in one channel of center 2
    if not sorted_dst:
        perm = rng.permutation(len(dst))
        dst, vals = dst[perm], vals[perm]
    src = np.arange(len(dst), dtype=np.int32)
    return vals, src, dst


def _grad_torch(fn, vals, cot):
    x = torch.tensor(vals, requires_grad=True)
    out = fn(x)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("name", ["max", "sum", "mean"])
@pytest.mark.parametrize("sorted_dst", [True, False])
def test_segment_ops_match_jax(name, sorted_dst):
    vals, _, dst = _case(0, sorted_dst)
    cot = np.random.default_rng(1).normal(
        size=(NUM_CENTERS, C)).astype(np.float32)
    jfn = jseg.AGGREGATIONS[name]

    def jloss(x):
        return jnp.sum(jfn(x, jnp.asarray(dst), NUM_CENTERS,
                           sorted=sorted_dst) * cot)

    want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(dst), NUM_CENTERS,
                          sorted=sorted_dst))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(vals)))
    got, got_g = _grad_torch(
        lambda x: tseg.AGGREGATIONS[name](x, torch.from_numpy(dst),
                                          NUM_CENTERS),
        vals, cot)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)
    # the empty center 4 is 0, and no sentinel edge reached a center
    assert (got[4] == 0).all()
    if name == "max":
        # tied winners share the cotangent
        assert np.allclose(got_g[dst == 1].sum(0), cot[1])


@pytest.mark.parametrize("name", ["max", "sum", "mean"])
@pytest.mark.parametrize("num_chunks", [1, 4, 3, 8, 16])
def test_chunked_aggregate_matches_jax(name, num_chunks):
    """An edge function over a table and a weight: values and the
    gradients of both, 1 chunk, 4 chunks (ties of center 1 split two and
    two across the boundary after edge 3), 3 chunks (16 % 3 != 0: one
    block, as in JAX), 8 chunks (the real edges end inside block 6, and
    block 7, padding only, is skipped) and 16 (three blocks skipped)."""
    vals, src, dst = _case(2)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(C, C)).astype(np.float32)
    cot = rng.normal(size=(NUM_CENTERS, C)).astype(np.float32)

    def jrun(table, weight):
        def edge_fn(s, d):
            return jax.nn.relu(table[s] @ weight)
        return jseg.chunked_aggregate(
            edge_fn, jnp.asarray(src), jnp.asarray(dst), NUM_CENTERS, C,
            name, num_chunks)

    want = np.asarray(jrun(jnp.asarray(vals), jnp.asarray(w)))
    jg = jax.grad(lambda t, m: jnp.sum(jrun(t, m) * cot), argnums=(0, 1))(
        jnp.asarray(vals), jnp.asarray(w))

    table = torch.tensor(vals, requires_grad=True)
    weight = torch.tensor(w, requires_grad=True)

    def edge_fn(s, d):
        return torch.relu(table[s.long()] @ weight)

    got = tseg.chunked_aggregate(edge_fn, torch.from_numpy(src),
                                 torch.from_numpy(dst), NUM_CENTERS, C,
                                 name, num_chunks)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    if num_chunks in (1, 3) or name == "max":
        # one block, or a max (exact): bitwise
        assert got.detach().numpy().tobytes() == want.tobytes()
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(jg[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(weight.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-6, atol=1e-6)


def test_tie_split_follows_chunk_boundaries():
    """Three tied winners, two in chunk 0 and one in chunk 1: the carry's
    maximum splits 0.5 / 0.5, then chunk 0's half splits again, as JAX
    does; one block splits in thirds."""
    vals = np.ones((4, 1), np.float32)
    vals[3] = 0.0
    src = np.arange(4, dtype=np.int32)
    order = np.array([0, 1, 3, 2], np.int32)  # edges 0, 1 | 3, 2
    for chunks, want in ((2, [0.25, 0.25, 0.5, 0.0]),
                         (1, [1 / 3, 1 / 3, 1 / 3, 0.0])):
        table = torch.tensor(vals, requires_grad=True)
        out = tseg.chunked_aggregate(
            lambda s, d: table[s.long()], torch.from_numpy(src[order]),
            torch.from_numpy(np.array([0, 0, 1, 0], np.int32)), 2, 1,
            "max", chunks)
        out[0, 0].backward()
        jg = jax.grad(lambda t: jseg.chunked_aggregate(
            lambda s, d: t[s], jnp.asarray(src[order]),
            jnp.asarray(np.array([0, 0, 1, 0], np.int32)), 2, 1, "max",
            chunks)[0, 0])(jnp.asarray(vals))
        np.testing.assert_allclose(table.grad.numpy()[:, 0], want,
                                   rtol=1e-6)
        np.testing.assert_allclose(table.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6)


def test_chunked_body_is_recomputed_in_the_backward():
    """Each chunk's edge function runs once forward and once more in the
    backward (the checkpointed body); without grad it runs once.  Every
    block that runs has the block's shape (the last one's three sentinel
    rows are computed and not reduced); a block of padding only would be
    skipped, and one block runs on its real edges only."""
    vals, src, dst = _case(4)
    table = torch.tensor(vals, requires_grad=True)
    calls = []

    def edge_fn(s, d):
        calls.append(len(s))
        return table[s.long()] * 2.0

    out = tseg.chunked_aggregate(edge_fn, torch.from_numpy(src),
                                 torch.from_numpy(dst), NUM_CENTERS, C,
                                 "max", 4)
    assert calls == [4] * 4
    out.sum().backward()
    assert calls == [4] * 8
    calls.clear()
    with torch.no_grad():
        tseg.chunked_aggregate(edge_fn, torch.from_numpy(src),
                               torch.from_numpy(dst), NUM_CENTERS, C,
                               "max", 4)
    assert calls == [4] * 4
    calls.clear()
    # 8 blocks of 2: the last (sentinels only) is skipped
    tseg.chunked_aggregate(edge_fn, torch.from_numpy(src),
                           torch.from_numpy(dst), NUM_CENTERS, C, "sum", 8)
    assert calls == [2] * 7
    calls.clear()
    tseg.chunked_aggregate(edge_fn, torch.from_numpy(src),
                           torch.from_numpy(dst), NUM_CENTERS, C, "max", 1)
    assert calls == [13]
