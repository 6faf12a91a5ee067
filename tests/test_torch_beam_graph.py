"""The port's beam loop in chunks, held to the JAX package's while_loop.

The port runs its steps in chunks of ``DONE_CHECK_EVERY`` with the step
counter on the device (on CUDA the chunks replay one captured graph; here
on the CPU the same step function runs eagerly), and the rest of
``max_steps`` past the last whole chunk without a done check.
These cases stop inside a chunk (max_steps 61 and below 8), so the loop
ends on that remainder.  Each bit width builds one JAX graph Index (n =
2000, dim = 32, R = 16, as tests/test_torch_beam.py does) and the port
loads its state; the JAX package's ``search_batch`` with ``debug_state``
is the reference for ids, the step each result was pushed, each query's
last improving step and the loop's step count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.api.index import Index as JIndex
from cphnsw_tpu.search import beam as jbeam
from cphnsw_tpu_torch import Index
from cphnsw_tpu_torch.search import beam as tbeam
from test_torch_beam import DIM, K, N, R, clustered, load_npz

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def queries():
    x = clustered(5, N, DIM)
    rng = np.random.default_rng(6)
    return x, x[rng.choice(N, 48, replace=False)] + 0.05 * \
        rng.standard_normal((48, DIM)).astype(np.float32)


@pytest.fixture(scope="module", params=[1, 4], ids=["1bit", "4bit"])
def pair(request, queries, tmp_path_factory):
    """(JAX index, the port's Index on the same state)."""
    bits = request.param
    jidx = JIndex(DIM, bits=bits, r=R).build(queries[0]).finalize()
    f = tmp_path_factory.mktemp("beam_graph") / f"j{bits}.npz"
    jidx.save(f)
    tidx = Index(DIM, bits=bits, r=R, device="cpu").load_state(*load_npz(f))
    return jidx, tidx


# (max_steps, expand_width, visited_hash_bits, rerank_width): 61 ends on a
# 5-step remainder after 7 whole chunks, 5 and 7 on a remainder alone
CASES = {
    "61-dense": (61, 1, 0, 0),
    "5-dense": (5, 1, 0, 0),
    "61-hash": (61, 1, 13, 0),
    "5-hash": (5, 1, 13, 0),
    "61-dense-wide": (61, 4, 0, 8),
    "61-hash-wide": (61, 4, 13, 8),
    "7-hash-wide": (7, 4, 13, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_steps_match_jax(pair, queries, case, monkeypatch):
    max_steps, ew, hash_bits, rw = CASES[case]
    jidx, tidx = pair
    q = queries[1]
    qpad = np.pad(q, ((0, 0), (0, tidx._padded - DIM)))
    kw = dict(bits=tidx._bits, k=K, beam_cap=2 * R, max_steps=max_steps,
              expand_width=ew, visited_hash_bits=hash_bits,
              rerank_width=rw, debug_state=True)
    ids_j, d_j, s_j = jbeam.search_batch(
        jidx._raw, jidx._norm_sq, jidx._neighbors, jidx._entry_candidates,
        jidx._signs, jnp.asarray(qpad), jidx._params, **kw)
    steps_j = int(s_j.steps)
    every = tbeam.DONE_CHECK_EVERY
    for check in (every, 1):
        monkeypatch.setattr(tbeam, "DONE_CHECK_EVERY", check)
        ids_t, d_t, s_t = tbeam.search_batch(
            tidx._raw, tidx._norm_sq, tidx._neighbors,
            tidx._entry_candidates, tidx._signs, torch.from_numpy(qpad),
            tidx._params, **kw)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(s_t.res_step.numpy(),
                                      np.asarray(s_j.res_step))
        np.testing.assert_array_equal(s_t.last_improve.numpy(),
                                      np.asarray(s_j.last_improve))
        # the done flags are read after whole chunks only: the loop runs on
        # to the next chunk's end, or to max_steps
        assert s_t.steps == min(max_steps, -(-steps_j // check) * check)
        # exact distances summed in another order: rtol 1e-5 of
        # |q|^2 + |x|^2, the terms the distance cancels
        raw = tidx._raw.numpy()
        ids = ids_t.numpy()
        scale = (qpad ** 2).sum(1)[:, None] + (raw ** 2).sum(1)[
            np.maximum(ids, 0)]
        err = np.abs(d_t.numpy() - np.asarray(d_j))
        assert (err[ids >= 0] <= 1e-5 * scale[ids >= 0]).all()


class _Store:
    """A stand-in neighbour store: the kept graphs are keyed on it weakly."""


def test_kept_graphs_within_bytes_per_device(monkeypatch):
    """The kept graphs of one device hold at most KEPT_BYTES_PER_DEVICE,
    the least recently used dropped first across stores; an entry larger
    than the budget is not kept; another device's entries are not
    counted; an entry goes with its store."""
    monkeypatch.setattr(tbeam, "KEPT_BYTES_PER_DEVICE", 100)
    monkeypatch.setattr(tbeam, "_REPLAYS", tbeam.weakref.WeakKeyDictionary())

    def keep(store, key, nbytes, device="cpu"):
        buf = tbeam.BeamState(*[None] * 11, done=torch.zeros(
            1, device=device), steps=0, last_improve=None, res_step=None)
        tbeam._keep(tbeam._REPLAYS.setdefault(store, {}), key,
                    tbeam._Replay(None, buf, None, nbytes, 0))

    def keys():
        return {k for kept in tbeam._REPLAYS.values() for k in kept}

    s0, s1 = _Store(), _Store()
    keep(s0, "a", 40)
    keep(s1, "b", 40)
    keep(s1, "m", 90, device="meta")
    assert keys() == {"a", "b", "m"}
    keep(s0, "c", 40)                 # 120 on the CPU: a goes
    assert keys() == {"b", "c", "m"}
    b = tbeam._REPLAYS[s1].pop("b")   # b replayed, kept again
    tbeam._keep(tbeam._REPLAYS[s1], "b", b)
    keep(s1, "d", 50)                 # 130: c, the least recent, goes
    assert keys() == {"b", "d", "m"}
    assert tbeam.kept_bytes("cpu") == 90 and tbeam.kept_bytes("meta") == 90
    assert tbeam.kept_bytes() == 180
    keep(s0, "e", 150)                # alone above the budget
    assert keys() == {"m"} and tbeam.kept_bytes("cpu") == 0
    keep(s0, "f", 30)
    del s0
    assert keys() == {"m"}
    tbeam.drop_replays()
    assert tbeam.kept_bytes() == 0
