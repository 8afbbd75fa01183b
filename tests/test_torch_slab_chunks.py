"""The work plan of the slab kernels (K1 slab_edge_max, K2 its backward),
in plain PyTorch on the CPU.

The kernels run over a pair list (every in-radius (center, row) pair,
grouped by center) cut into chunks of ``slab.PAIR_CHUNK`` pairs: each
chunk's chain, a segmented max per center in the chunk, a max across
chunks; the backward sums per chunk and then over chunks in a fixed
order, and the table gradient of a row over the source-sorted view of
the list.  These tests build the list with the wrappers' own functions
(``pair_list``, ``pair_chunks``, ``source_order``) on a skewed frame (one
center with several hundred neighbours) and hold the chunked plain
forward and backward against the plain versions.  ``skewed_case`` is
also used by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from pointgnn_tpu_torch.nn import slab

G, R, BK = 8, 1.5, 32
BLOB = 420  # points within 0.6 m of the crowded center


def skewed_case(seed, widths, level=0, tie=False):
    """Keyword arguments of one slab call: ``widths[0]`` is the table
    width, the rest the tail's outputs.  Level 0: distinct sources and
    centers; level 1: one set.  A blob of ``BLOB`` sources sits around
    the first center, so one center block holds far more pairs than the
    others; pad rows and pad centers are included.  ``tie`` duplicates
    a blob row (coordinates and table row), so both copies tie wherever
    one wins."""
    rng = np.random.default_rng(seed)
    n_uniform = 384 if level == 0 else 256
    c_star = np.array([5.2, 0.0, 5.2], np.float32)
    xyz = np.concatenate([
        np.stack([rng.uniform(0, 11, n_uniform), rng.uniform(-1, 1, n_uniform),
                  rng.uniform(0, 11, n_uniform)], 1),
        c_star + rng.uniform(-0.35, 0.35, (BLOB, 3)),
    ]).astype(np.float32)
    xyz[:3, 1] = 40.0 + np.arange(3) * 10  # isolated points
    p = xyz.shape[0]
    valid = np.ones(p, bool)
    valid[n_uniform - 16:n_uniform] = False
    cx = np.clip((xyz[:, 0] // R).astype(int), 0, G - 1)
    cz = np.clip((xyz[:, 2] // R).astype(int), 0, G - 1)
    cell = np.where(valid, cx * G + cz, G * G)
    order = np.argsort(cell, kind="stable")
    xyz, cell, valid = xyz[order], cell[order], valid[order]
    offsets = np.searchsorted(cell, np.arange(G * G + 1)).astype(np.int32)
    h = widths[0]
    a = rng.normal(size=(p, h)).astype(np.float32)
    if tie:
        # the blob's first two rows in cell order: same cell, so moving the
        # second onto the first keeps the order valid
        blob = np.nonzero(np.abs(xyz - c_star).max(1) < 0.4)[0]
        j = blob[0]
        j2 = blob[1]
        if cell[j2] == cell[j]:
            xyz[j2] = xyz[j]
            a[j] += 3.0
            a[j2] = a[j]
    if level == 0:
        k = 256
        kidx = np.sort(rng.choice(np.nonzero(valid)[0], k, replace=False))
        kxyz, kvalid = xyz[kidx].copy(), valid[kidx].copy()
        kxyz[0] = c_star
        kvalid[k - 10:] = False
        kxyz[5:8, 1] = 50.0  # valid centers with no point in radius
        kcell_all = (np.clip((kxyz[:, 0] // R).astype(int), 0, G - 1) * G
                     + np.clip((kxyz[:, 2] // R).astype(int), 0, G - 1))
        kcell = np.where(kvalid, kcell_all, G * G).astype(np.int32)
        korder = np.argsort(kcell, kind="stable")
        kxyz, kvalid, kcell = kxyz[korder], kvalid[korder], kcell[korder]
    else:
        k = p
        kxyz, kvalid, kcell = xyz, valid, cell.astype(np.int32)
    b = rng.normal(size=(k, h)).astype(np.float32)
    tail = []
    for din, dout in zip(widths[:-1], widths[1:]):
        tail.append((
            torch.from_numpy((rng.normal(size=(din, dout)) / np.sqrt(din))
                             .astype(np.float32)),
            torch.from_numpy((rng.normal(size=(dout,)) * 0.1)
                             .astype(np.float32)),
        ))
    src4 = np.concatenate([xyz, np.zeros((p, 1), np.float32)], 1)
    src4[~valid] = 1e6
    ctr4 = np.concatenate([kxyz, np.zeros((k, 1), np.float32)], 1)
    ctr4[~kvalid] = -1e6
    t = torch.from_numpy
    return dict(table_a=t(a), src_xyz=t(src4), table_b=t(b),
                ctr_xyz=t(np.ascontiguousarray(ctr4)), offsets=t(offsets),
                center_cell=t(np.ascontiguousarray(kcell)), weights=tail,
                grid_g=G, radius=R, block_centers=BK)


def _plan(kw):
    win_lo, win_hi = slab.column_row_windows(
        kw["offsets"], kw["center_cell"], G, BK, 1)
    return slab.pair_list(kw["src_xyz"], kw["ctr_xyz"], win_lo, win_hi, BK,
                          R)


CASES = [(0, [16, 16, 24, 32]), (1, [32, 32])]


@pytest.mark.parametrize("level,widths", CASES)
def test_every_pair_in_exactly_one_chunk(level, widths):
    kw = skewed_case(level, widths, level)
    row_ptr, pair_k, pair_j = _plan(kw)
    n = pair_k.numel()
    k = kw["table_b"].shape[0]
    assert row_ptr.shape == (k + 1,) and int(row_ptr[0]) == 0
    assert int(row_ptr[-1]) == n
    # each center's pairs form one run at its offsets, rows ascending
    assert bool((row_ptr[1:] >= row_ptr[:-1]).all())
    runs = torch.repeat_interleave(torch.arange(k), (row_ptr[1:]
                                                     - row_ptr[:-1]).long())
    assert torch.equal(runs.to(torch.int32), pair_k)
    same = pair_k[1:] == pair_k[:-1]
    assert bool((pair_j[1:][same] > pair_j[:-1][same]).all())
    # the list is exactly the plain enumeration of in-radius pairs
    win_lo, win_hi = slab.column_row_windows(
        kw["offsets"], kw["center_cell"], G, BK, 1)
    want = set()
    for kk, jj in slab._inradius_pairs(kw["src_xyz"], kw["ctr_xyz"], win_lo,
                                       win_hi, BK, R):
        want |= set(zip(kk.tolist(), jj.tolist()))
    assert set(zip(pair_k.tolist(), pair_j.tolist())) == want
    # the chunks tile the list once, in order
    chunks = slab.pair_chunks(n)
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(b - a == slab.PAIR_CHUNK for a, b in chunks[:-1])
    assert all(x[1] == y[0] for x, y in zip(chunks[:-1], chunks[1:]))
    # skew: the crowded center holds several hundred pairs
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    assert int(counts.max()) >= 300
    n_pairs, n_chunks, heaviest = slab.pair_stats(
        kw["src_xyz"], kw["ctr_xyz"], kw["offsets"], kw["center_cell"], G,
        R, block_centers=BK)
    assert (n_pairs, n_chunks) == (n, len(chunks))
    blocks = torch.zeros(-(-k // BK) * BK, dtype=torch.int64)
    blocks[:k] = counts
    per_block = blocks.reshape(-1, BK).sum(1)
    assert heaviest == int(per_block.max())


def test_source_order_is_stable_by_row():
    kw = skewed_case(3, [16, 16], 1)
    _, pair_k, pair_j = _plan(kw)
    p = kw["table_a"].shape[0]
    perm, src_ptr = slab.source_order(pair_j, p)
    js = pair_j[perm.long()]
    assert bool((js[1:] >= js[:-1]).all())
    same = js[1:] == js[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())
    assert src_ptr.shape == (p + 1,) and int(src_ptr[-1]) == pair_j.numel()
    for j in torch.unique(pair_j)[:20].tolist():
        assert bool((js[src_ptr[j]:src_ptr[j + 1]] == j).all())


def _chunk_acts(kw, pair_k, pair_j, s, e, compute_dtype):
    a, b, chain = slab._rounded_operands(kw["table_a"], kw["table_b"],
                                         kw["weights"], compute_dtype)
    kc, jc = pair_k[s:e].long(), pair_j[s:e].long()
    return kc, jc, slab._chain_acts(a, b, chain, kc, jc, compute_dtype)


def chunked_forward(kw, compute_dtype):
    """Per chunk: the chain, a segmented max over each center's run; then
    the max across chunks into a zeroed output."""
    _, pair_k, pair_j = _plan(kw)
    k = kw["table_b"].shape[0]
    h_out = kw["weights"][-1][0].shape[1]
    out = torch.zeros(k, h_out)
    for s, e in slab.pair_chunks(pair_k.numel()):
        kc, _, acts = _chunk_acts(kw, pair_k, pair_j, s, e, compute_dtype)
        y = acts[-1]
        centers, run = torch.unique_consecutive(kc, return_counts=True)
        seg = torch.stack([r.max(0).values
                           for r in torch.split(y, run.tolist())])
        out[centers] = torch.maximum(out[centers], seg)
    return out


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level,widths", CASES)
def test_chunked_forward_equals_plain_version(level, widths, compute_dtype):
    kw = skewed_case(10 + level, widths, level)
    ref = slab.slab_edge_max_reference(**kw, compute_dtype=compute_dtype)
    got = chunked_forward(kw, compute_dtype)
    assert torch.equal(got, ref)
    assert int((ref.abs().sum(1) > 0).sum()) > 0


def chunked_backward(kw, out, g):
    """Per chunk: the recompute, the winner cotangent (every tied winner
    gets g), the backward products into a per-chunk partial, and
    d_table_b as per-center segment sums; the partials summed in chunk
    order, d_table_a over the source-sorted view.  The sums across chunks
    and pairs run in float64, so what differs from the plain version is
    the plan (pairs, winners, order), not the rounding of long f32 sums."""
    row_ptr, pair_k, pair_j = _plan(kw)
    weights = kw["weights"]
    _, _, chain = slab._rounded_operands(kw["table_a"], kw["table_b"],
                                         weights, "float32")
    n = pair_k.numel()
    h = kw["table_a"].shape[1]
    dz0 = torch.zeros(n, h, dtype=torch.float64)
    parts = []
    for s, e in slab.pair_chunks(n):
        kc, _, acts = _chunk_acts(kw, pair_k, pair_j, s, e, "float32")
        y = acts[-1]
        dz = torch.where((y == out[kc]) & (y > 0), g[kc], torch.zeros(()))
        part = []
        for li in range(len(chain) - 1, -1, -1):
            part.append((acts[li].T @ dz, dz.sum(0)))
            dz = (dz @ chain[li][0].T) * (acts[li] > 0)
        parts.append(part[::-1])
        dz0[s:e] = dz.double()
    d_chain = []
    for li in range(len(chain)):
        dw = torch.zeros_like(chain[li][0], dtype=torch.float64)
        db = torch.zeros_like(chain[li][1], dtype=torch.float64)
        for part in parts:  # fixed chunk order
            dw += part[li][0]
            db += part[li][1]
        d_chain.append((dw.float(), db.float()))
    k = kw["table_b"].shape[0]
    d_b = torch.zeros(k, h, dtype=torch.float64)
    for c in range(k):
        d_b[c] = -dz0[row_ptr[c]:row_ptr[c + 1]].sum(0)
    p = kw["table_a"].shape[0]
    perm, src_ptr = slab.source_order(pair_j, p)
    rows = dz0[perm.long()]
    d_a = torch.zeros(p, h, dtype=torch.float64)
    for j in torch.unique(pair_j).tolist():
        d_a[j] = rows[src_ptr[j]:src_ptr[j + 1]].sum(0)
    return d_a.float(), d_b.float(), d_chain


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("level,widths", CASES)
def test_chunked_backward_matches_plain_version(level, widths, tie):
    kw = skewed_case(20 + level, widths, level, tie=tie)
    out = slab.slab_edge_max_reference(**kw, compute_dtype="float32")
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(out.shape)).astype(np.float32))
    ref = slab.slab_edge_max_backward_reference(
        **kw, out=out, g=g, compute_dtype="float32")
    got = chunked_backward(kw, out, g)
    flat = lambda r: [r[0], r[1]] + [t for wb in r[2] for t in wb]  # noqa
    for x, z in zip(flat(got), flat(ref)):
        assert x.shape == z.shape
        err = (x - z).abs().max().item()
        assert err <= 1e-6 * (1 + z.abs().max().item()), err
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0
