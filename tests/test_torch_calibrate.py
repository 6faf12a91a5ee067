"""The port's EVT-CRC calibration against the JAX package on the same graph.

Each bit width builds one JAX graph Index; the port loads that very state,
so the device pass (``_collect_samples``) and the whole pipeline
(``calibrate``) see identical inputs in both packages.  Each tolerance is
stated where it is checked, with its reason.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cphnsw_tpu.api.index import Index as JIndex
from cphnsw_tpu.calibration import calibrate as jcal
from cphnsw_tpu_torch import Index
from cphnsw_tpu_torch.calibration import calibrate as tcal

torch.set_num_threads(2)

N, DIM, R = 2000, 32, 16
SNAPSHOT_KEYS = ("affine_a", "affine_b", "search_gamma", "gamma_min",
                 "gamma_max", "gamma_beta")


def clustered(seed, n, dim, n_clusters=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    return centers[rng.integers(0, n_clusters, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["1bit", "2bit",
                                                       "4bit"])
def pair(request, tmp_path_factory):
    """(JAX index, the port's Index on the same state)."""
    bits = request.param
    jidx = JIndex(DIM, bits=bits, r=R).build(clustered(8, N, DIM)).finalize()
    f = tmp_path_factory.mktemp("cal") / f"j{bits}.npz"
    jidx.save(f)
    with np.load(f) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "header"}
    return jidx, Index(DIM, bits=bits, r=R, device="cpu").load_state(
        header, arrays)


def test_collect_samples_match(pair):
    jidx, tidx = pair
    rng = np.random.default_rng(0)
    q = np.asarray(jidx._raw)[rng.choice(N, 300, replace=False)]
    q = (q + rng.standard_normal(q.shape).astype(np.float32)).astype(
        np.float32)
    parent0 = rng.choice(N, 300).astype(np.int32)
    want = jcal._collect_samples(jidx._raw, jidx._norm_sq, jidx._neighbors,
                                 jidx._signs, jidx._bits, jnp.asarray(q),
                                 jnp.asarray(parent0))
    got = tcal._collect_samples(tidx._raw, tidx._norm_sq, tidx._neighbors,
                                tidx._signs, tidx._bits, torch.from_numpy(q),
                                torch.from_numpy(parent0).long())
    names = ("nn_dist_sq", "ip_corrected", "ip_qo", "nop", "dist_qp_sq",
             "true_ip", "true_dist", "valid")
    g, w = dict(zip(names, got)), dict(zip(names, want))
    np.testing.assert_array_equal(g["valid"], w["valid"])
    np.testing.assert_array_equal(g["ip_qo"], w["ip_qo"])   # stored aux
    np.testing.assert_array_equal(g["nop"], w["nop"])
    v = w["valid"]
    # f32 sums taken in another order: rtol 1e-5 of each quantity's own
    # scale (distances: the norms they cancel; inner products: their
    # largest magnitude, since they are signed and cross zero)
    for name in ("nn_dist_sq", "dist_qp_sq", "true_dist"):
        np.testing.assert_allclose(g[name], w[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(w[name]).max(),
                                   err_msg=name)
    for name in ("ip_corrected", "true_ip"):
        np.testing.assert_allclose(g[name][v], w[name][v], rtol=1e-5,
                                   atol=1e-5 * np.abs(w[name][v]).max(),
                                   err_msg=name)


def test_calibrate_matches(pair):
    jidx, tidx = pair
    prof = tcal.IndexProfile.from_dict(jidx._profile.to_dict())
    got = tcal.calibrate(tidx._raw, tidx._norm_sq, tidx._neighbors,
                         tidx._signs, tidx._bits, prof,
                         seed=42 + 99999).to_dict()
    want = jidx._snapshot.to_dict()
    # the same samples up to f32 order, then identical host numpy: the
    # fitted scalars within rtol 1e-3 (quantiles of near-equal residuals)
    for key in SNAPSHOT_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   err_msg=key)
    assert got["gamma_warmup"] == want["gamma_warmup"]
    assert got["search_num_slack_levels"] == want["search_num_slack_levels"]
    np.testing.assert_allclose(got["search_ip_slack_levels"],
                               want["search_ip_slack_levels"], rtol=1e-2)


@pytest.mark.parametrize("n", [60, 2000, 1_000_000])
def test_index_profile_matches(n):
    want = jcal.IndexProfile.derive(n, 128, 32, 4).to_dict()
    assert tcal.IndexProfile.derive(n, 128, 32, 4).to_dict() == want


def test_snapshot_round_trips_through_json(pair):
    jidx, _ = pair
    d = json.loads(json.dumps(jidx._snapshot.to_dict(), default=float))
    snap = tcal.CalibrationSnapshot.from_dict(d)
    assert json.loads(json.dumps(snap.to_dict(), default=float)) == d
