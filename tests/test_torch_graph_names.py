"""Names the port shares with the JAX package's graph engine:
``SearchParams.default``, the ``NeighborStore`` channel views, and the
``chunk`` overrides of the chunked build stages (which change no result).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.graph import build as jbuild
from cphnsw_tpu.search import beam as jbeam
from cphnsw_tpu_torch.graph import build as tbuild
from cphnsw_tpu_torch.graph import nndescent as tnnd
from cphnsw_tpu_torch.ops import hadamard as thad
from cphnsw_tpu_torch.search import beam as tbeam

torch.set_num_threads(2)

N, R, BITS, WORDS = 300, 8, 2, 1


@pytest.mark.parametrize("num_levels", [4, 7])
def test_search_params_default_matches_jax(num_levels):
    want = jbeam.SearchParams.default(num_levels)
    got = tbeam.SearchParams.default(num_levels, device="cpu")
    assert got._fields == want._fields
    for name in got._fields:
        if name == "slack_levels":
            continue
        # f32 / int32 scalars there, f32-valued Python scalars here
        assert getattr(got, name) == np.asarray(getattr(want, name)).item()
    assert isinstance(got.gamma_warmup, int)
    assert got.slack_levels.dtype == torch.float32
    assert got.slack_levels.device.type == "cpu"
    np.testing.assert_array_equal(got.slack_levels.numpy(),
                                  np.asarray(want.slack_levels))
    assert tbeam.SearchParams.default(
        device="cpu").slack_levels.shape == (4,)
    assert tbeam.SearchParams.default(
        device="meta").slack_levels.device.type == "meta"


def test_neighbor_store_views_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, N, (N, R)).astype(np.int32)
    planes = rng.integers(0, 2 ** 31, (N, R, BITS, WORDS)).astype(np.int32)
    aux = rng.standard_normal((N, R, 4)).astype(np.float32)
    want = jbuild.NeighborStore.pack(
        jnp.asarray(ids), jnp.asarray(planes.view(np.uint32)),
        jnp.asarray(aux))
    got = tbuild.NeighborStore.pack(
        torch.from_numpy(ids), torch.from_numpy(planes),
        torch.from_numpy(aux))
    np.testing.assert_array_equal(got.fused.numpy(), np.asarray(want.fused))
    for c, name in enumerate(("nop", "ip_qo", "ip_cp", "wpc")):
        view = getattr(got, name)
        assert view.shape == (N, R) and view.dtype == torch.float32
        np.testing.assert_array_equal(view.numpy(),
                                      np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(view.numpy(), aux[..., c])


@pytest.fixture(scope="module")
def small_graph():
    rng = np.random.default_rng(1)
    dim = 16
    raw = torch.from_numpy(rng.standard_normal((N, dim)).astype(np.float32))
    norm_sq = (raw * raw).sum(1)
    nop = (raw - raw.mean(0)).norm(dim=1)
    cand = torch.from_numpy(rng.integers(0, N, (N, 24)).astype(np.int32))
    cand[:, -3:] = -1
    d = ((raw[:, None, :] - raw[cand.clamp_min(0).long()]) ** 2).sum(-1)
    d = torch.where(cand >= 0, d, torch.finfo(torch.float32).max)
    return raw, norm_sq, nop, cand, d


@pytest.mark.parametrize("chunk", [64, 299, 1000])
def test_chunked_prune_chunk_changes_nothing(small_graph, chunk):
    raw, norm_sq, nop, cand, d = small_graph
    args = (raw, norm_sq, cand, d, nop, 1.2, 0.0, 2.0, R, 0.25)
    want_i, want_d = tbuild._chunked_prune(*args)
    got_i, got_d = tbuild._chunked_prune(*args, chunk=chunk)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    assert (want_i >= 0).any()


@pytest.mark.parametrize("chunk", [64, 299, 1000])
def test_encode_neighbor_blocks_chunk_changes_nothing(small_graph, chunk):
    raw, _, _, cand, _ = small_graph
    sel = cand[:, :R].contiguous()
    sel[::7, -1] = -1
    signs = thad.rotation_signs(42, raw.shape[1])
    want = tbuild.encode_neighbor_blocks(raw, sel, signs, BITS)
    got = tbuild.encode_neighbor_blocks(raw, sel, signs, BITS, chunk=chunk)
    np.testing.assert_array_equal(got.fused.numpy(), want.fused.numpy())
    np.testing.assert_array_equal(got.ids.numpy(), sel.numpy())


def test_init_random_chunk_override(small_graph):
    """A chunk override draws per chunk from the chain of keys split from
    PRNGKey(seed), as the JAX package's does: the default chunk passed in
    is the default call, and another chunk gives JAX's graph for that
    chunk (another graph, in both packages alike)."""
    from cphnsw_tpu.graph import nndescent as jnnd

    raw, norm_sq, _, _, _ = small_graph

    def run(**kw):
        return tnnd.init_random(raw, norm_sq, R, seed=5, **kw)

    base = run()
    same = run(chunk=N)
    np.testing.assert_array_equal(same.ids.numpy(), base.ids.numpy())
    for chunk in (100, 128):
        other = run(chunk=chunk)
        want = jnnd.init_random(jnp.asarray(raw.numpy()),
                                jnp.asarray(norm_sq.numpy()), R, seed=5,
                                chunk=chunk)
        # the same draws and stable sorts: equal ids; distances summed in
        # another order: within 1e-6 of the norms the subtraction cancels
        np.testing.assert_array_equal(other.ids.numpy(),
                                      np.asarray(want.ids))
        ids = np.asarray(want.ids)
        ns = norm_sq.numpy()
        scale = ns[:, None] + ns[np.maximum(ids, 0)]
        assert (np.abs(other.dists.numpy() - np.asarray(want.dists))
                <= 1e-6 * scale).all()
    assert not np.array_equal(other.ids.numpy(), base.ids.numpy())
