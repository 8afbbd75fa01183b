"""The work plan of the edge-list tail kernels (K3 edge_tail_max, K4
fused_edge_max), in plain PyTorch on the CPU.

The kernels list every valid slot as a (center, row) pair in center order
(``edge_tail.tail_pair_list``), cut the list into chunks of
``edge_tail.PAIR_CHUNK`` pairs, run the chain on each chunk, take a
segmented max per center inside the chunk and a max across chunks, and
give a center without a valid slot 0.  These tests build the list with
the wrappers' own functions on several valid-flag patterns (front-packed
as the device builder packs them, random holes, a center with every
slot valid, centers with none, none valid at all) and hold the chunked
plain forward bitwise against the plain versions, and one case against
the JAX kernel in interpret mode.  ``tail_case`` also feeds
``tests/test_torch_cuda.py``, which runs without JAX, so JAX is imported
only inside the test that needs it.
"""

import numpy as np
import pytest
import torch

from pointgnn_tpu_torch.nn import edge_tail, slab
from pointgnn_tpu_torch.nn.mlp import round_to

PATTERNS = ("front_packed", "holes", "all_invalid")
# (table width, tail widths): the car_auto_T3 tails, widths that are not
# multiples of 4 (the kernels then read rows one value a load), and an
# empty chain
CHAINS = {
    "car_l0": (32, [64, 128, 300]),
    "car_l1": (300, [300]),
    "odd": (30, [20, 7]),
    "empty": (24, []),
}


def tail_case(seed, pattern, h, widths, k=24, s=72, compute_dtype="float32"):
    """Keyword arguments of one K3 call and one K4 call on the same rows.
    ``s`` > ``PAIR_CHUNK`` so that a full center spans two chunks.
    Center 0 has every slot valid and center 1 none (but for
    ``all_invalid``, where none has any)."""
    rng = np.random.default_rng(seed)
    n = 3 * k
    if pattern == "front_packed":
        counts = rng.integers(0, s + 1, k)
        valid = np.arange(s)[None, :] < counts[:, None]
    elif pattern == "holes":
        valid = rng.uniform(size=(k, s)) > 0.4
    else:
        valid = np.zeros((k, s), bool)
    if pattern != "all_invalid":
        valid[0] = True
        valid[1] = False
    src = np.where(valid, rng.integers(0, n, (k, s)), n).astype(np.int32)
    cd = getattr(torch, compute_dtype)
    a = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(cd)
    b = torch.from_numpy(rng.normal(size=(k, h)).astype(np.float32)).to(cd)
    chain = []
    for din, dout in zip([h] + widths[:-1], widths):
        w = rng.normal(size=(din, dout)) / np.sqrt(din)
        bb = rng.normal(size=(dout,)) * 0.1
        chain.append((torch.from_numpy(w.astype(np.float32)).to(cd),
                      torch.from_numpy(bb.astype(np.float32)).to(cd)))
    valid_t = torch.from_numpy(valid.astype(np.float32))
    src_t = torch.from_numpy(src)
    gathered = a.index_select(0, torch.clamp(src_t.reshape(-1).long(),
                                             max=n - 1))
    return (dict(gathered=gathered, table_b=b, slot_valid=valid_t,
                 weights=chain),
            dict(table_a=a, table_b=b, edges_src=src_t, slot_valid=valid_t,
                 weights=chain))


def chunked_forward(rows, table_b, slot_valid, weights, apply_act_first,
                    edges_src=None):
    """The kernels' plan in plain PyTorch: the pair list, chunks of
    ``PAIR_CHUNK`` pairs, the chain per chunk with the kernels' rounding
    points, a max per center across chunks, 0 where a center has no
    valid slot."""
    cd = str(rows.dtype).replace("torch.", "")
    k, h = table_b.shape
    n_rows = rows.shape[0]
    _, pair_k, pair_r = edge_tail.tail_pair_list(slot_valid, edges_src,
                                                 n_rows)
    chain = [(round_to(w.float(), cd), round_to(bb.float(), cd))
             for w, bb in weights]
    h_out = chain[-1][0].shape[1] if chain else h
    out = torch.full((k, h_out), edge_tail.NEG)
    for s0, s1 in slab.pair_chunks(pair_k.numel(), edge_tail.PAIR_CHUNK):
        kc, rc = pair_k[s0:s1].long(), pair_r[s0:s1].long()
        x = round_to(rows[rc].float() - table_b[kc].float(), cd)
        if apply_act_first:
            x = torch.relu(x)
        for w, bb in chain:
            x = round_to(torch.relu(x @ w + bb), cd)
        out.scatter_reduce_(0, kc[:, None].expand(-1, h_out), x, "amax",
                            include_self=True)
    return torch.where(out > edge_tail.NEG / 2, out, torch.zeros(()))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_pair_list_is_the_valid_slots_in_center_order(pattern, fused):
    k3, k4 = tail_case(1, pattern, 8, [8])
    valid = k3["slot_valid"].numpy() > 0
    src = k4["edges_src"].numpy()
    n = k4["table_a"].shape[0]
    row_ptr, pair_k, pair_r = edge_tail.tail_pair_list(
        k3["slot_valid"], k4["edges_src"] if fused else None, n)
    want_k, want_r = [], []
    for c in range(valid.shape[0]):
        for s in range(valid.shape[1]):
            if valid[c, s]:
                want_k.append(c)
                want_r.append(min(max(src[c, s], 0), n - 1) if fused
                              else c * valid.shape[1] + s)
    assert pair_k.dtype == pair_r.dtype == row_ptr.dtype == torch.int32
    assert pair_k.tolist() == want_k
    assert pair_r.tolist() == want_r
    assert row_ptr.tolist() == [0] + np.cumsum(valid.sum(1)).tolist()
    # every pair lies in exactly one chunk
    chunks = slab.pair_chunks(len(want_k), edge_tail.PAIR_CHUNK)
    assert sum(e - s for s, e in chunks) == len(want_k)
    if pattern != "all_invalid":
        # center 0 (all S = 72 slots valid) spans two chunks
        assert row_ptr[1] > edge_tail.PAIR_CHUNK


def test_pair_list_takes_the_device_builders_layout():
    """Front-packed slots with the sentinel ``src == N`` on the rest, as
    ``radius_edges`` writes them: K4's rows are the sources, K3's the
    slot indices, and both lists have the same centers."""
    k3, k4 = tail_case(2, "front_packed", 8, [8])
    n = k4["table_a"].shape[0]
    r3 = edge_tail.tail_pair_list(k3["slot_valid"])
    r4 = edge_tail.tail_pair_list(k4["slot_valid"], k4["edges_src"], n)
    assert torch.equal(r3[0], r4[0]) and torch.equal(r3[1], r4[1])
    assert torch.equal(r4[2], k4["edges_src"].reshape(-1)[r3[2].long()])
    assert (r4[2] < n).all()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", ["car_l0", "car_l1", "odd"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_chunked_forward_equals_plain_versions(pattern, chain,
                                               compute_dtype):
    h, widths = CHAINS[chain]
    k3, k4 = tail_case(3, pattern, h, widths, compute_dtype=compute_dtype)
    ref3 = edge_tail.edge_tail_max_reference(**k3)
    ref4 = edge_tail.fused_edge_max_reference(**k4)
    got3 = chunked_forward(k3["gathered"], k3["table_b"], k3["slot_valid"],
                           k3["weights"], True)
    got4 = chunked_forward(k4["table_a"], k4["table_b"], k4["slot_valid"],
                           k4["weights"], True, k4["edges_src"])
    assert torch.equal(got3, ref3)
    assert torch.equal(got4, ref4)
    assert torch.equal(ref3, ref4)
    empty = k3["slot_valid"].sum(1) == 0
    assert (got3[empty] == 0).all()
    if pattern == "all_invalid":
        assert (got3 == 0).all()
    else:
        assert (got3[~empty] != 0).any()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_signed_empty_chain(pattern):
    """No chain and no first ReLU: the outputs are ``rnd(row - B)``,
    signed.  A center with valid slots keeps a negative max; only a
    center without one gets 0."""
    h, widths = CHAINS["empty"]
    k3, k4 = tail_case(4, pattern, h, widths, compute_dtype="bfloat16")
    ref = edge_tail.edge_tail_max_reference(**k3, apply_act_first=False)
    got3 = chunked_forward(k3["gathered"], k3["table_b"], k3["slot_valid"],
                           k3["weights"], False)
    got4 = chunked_forward(k4["table_a"], k4["table_b"], k4["slot_valid"],
                           k4["weights"], False, k4["edges_src"])
    assert torch.equal(got3, ref)
    assert torch.equal(got4, ref)
    assert torch.equal(edge_tail.fused_edge_max_reference(
        **k4, apply_act_first=False), ref)
    assert ref.shape == (k3["table_b"].shape[0], h)
    empty = k3["slot_valid"].sum(1) == 0
    assert (ref[empty] == 0).all()
    if pattern != "all_invalid":
        assert (ref[~empty] < 0).any()


def test_chunked_forward_matches_jax_interpret():
    """The plan against the TPU kernel itself (Pallas in interpret
    mode) on the car level-0 chain in bf16, random holes."""
    import jax.numpy as jnp

    from pointgnn_tpu.nn import pallas_kernels as pk

    h, widths = CHAINS["car_l0"]
    k3, _ = tail_case(5, "holes", h, widths, k=16, s=40,
                      compute_dtype="bfloat16")

    def jx(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    flat = tuple(jx(x) for wb in k3["weights"] for x in wb)
    want = np.asarray(pk.edge_tail_max(
        jx(k3["gathered"]), jx(k3["table_b"]),
        jnp.asarray(k3["slot_valid"].numpy()), flat, interpret=True))
    got = chunked_forward(k3["gathered"], k3["table_b"], k3["slot_valid"],
                          k3["weights"], True).numpy()
    # a sum on the other side of a bf16 rounding boundary moves an
    # activation by one bf16 ulp (2^-8), carried by later layers
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= 2e-2, err.max()
    assert (got[1] == 0).all() and (want[1] == 0).all()
