"""The rest of the port's data layer against the JAX package's: the ring
fixture, pad_graph_np and atom_mask; the device k-NN (``neighbors_device``)
and device fragments (``fragment_device``) array for array on random
coordinates, and their tie order on a lattice; the organic molecules and
their TFRecord fragments record for record from the same seed.

The device builds use the |x|^2 + |y|^2 - 2 x.y distances in float32,
whose rounding the two packages' CPU products may take in another order:
where a slot's squared distance lies within 1e-3 A^2 of the next or the
previous candidate's, the order is a rounding tie, and only there may the
indices differ (under 1% of the slots)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu import graph as jgraph
from nmrgnn_tpu.data import organic as jorganic
from nmrgnn_tpu.data.device_graph import fragment_device as jfragment_device
from nmrgnn_tpu.data.neighbors import neighbors_device as jneighbors_device
from nmrgnn_tpu_torch import graph as tgraph
from nmrgnn_tpu_torch.data import organic
from nmrgnn_tpu_torch.data.device_graph import fragment_device
from nmrgnn_tpu_torch.data.neighbors import neighbors_device, neighbors_host
from nmrgnn_tpu_torch.data.tfrecord import read_tfrecord

torch.set_num_threads(2)


@pytest.mark.parametrize("n,k,elements", [(5, 2, None), (7, 3, [1, 2, 3, 4, 5, 6, 7])])
def test_ring_pad_and_mask_match_jax(n, k, elements):
    want = jgraph.ring_graph(n, k, elements=elements)
    got = tgraph.ring_graph(n, k, elements=elements)
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    padded = tgraph.pad_graph_np(*got, pad_to=n + 3)
    for a, b in zip(padded, jgraph.pad_graph_np(*map(np.asarray, want), pad_to=n + 3)):
        np.testing.assert_array_equal(a, b)
    mask = jgraph.atom_mask(jgraph.Graph(*map(jnp.asarray, padded)))
    np.testing.assert_array_equal(tgraph.atom_mask(tgraph.Graph(*padded)), np.asarray(mask))
    t_mask = tgraph.atom_mask(tgraph.Graph(*map(torch.from_numpy, padded)))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    with pytest.raises(ValueError):
        tgraph.pad_graph_np(*got, pad_to=n - 1)


def _agree_but_rounding_ties(got_idx, want_idx, d2_sorted):
    """Indices equal at every slot whose squared distance (``d2_sorted``,
    ascending, one column more than the slots, inf where no candidate) is
    no rounding tie with its neighbors'; returns the share of slots that
    had to be excused."""
    with np.errstate(invalid="ignore"):  # inf - inf: no candidate on either side
        near = np.diff(d2_sorted, axis=1) < 1e-3      # slot j vs slot j + 1
    excused = near | np.pad(near, ((0, 0), (1, 0)))[:, :-1]
    assert np.array_equal(got_idx[~excused], want_idx[~excused])
    return excused.mean()


@pytest.mark.parametrize("n,k,n_real,block", [(700, 16, None, 512), (300, 16, 250, 128),
                                              (10, 16, None, 512)])
def test_neighbors_device_matches_jax(n, k, n_real, block):
    rng = np.random.default_rng(n)
    coords = (rng.uniform(0, 30, (n, 3))).astype(np.float32)
    want_i, want_d = jneighbors_device(jnp.asarray(coords), k,
                                       None if n_real is None else jnp.int32(n_real), block)
    got_i, got_d = neighbors_device(torch.from_numpy(coords), k, n_real, block)
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=2e-3)
    # each slot's squared distance and the (k+1)-th, from the host's k-NN
    m = n if n_real is None else n_real
    _, host_d = neighbors_host(coords[:m], k + 1, use_native=False)
    d2 = host_d.astype(np.float64) ** 2
    d2[:, max(m - 1, 0):] = np.inf  # no candidate there: index 0 in both
    d2 = np.pad(d2, ((0, n - m), (0, 0)), constant_values=np.inf)
    assert _agree_but_rounding_ties(got_i.numpy(), want_i, d2) < 0.01
    if n_real is not None:
        assert not got_i[n_real:].any() and not got_d[n_real:].any()
        assert int(got_i[:n_real].max()) < n_real
    if n - 1 < k:  # padded slots: index 0, distance 0
        assert not got_i[:, n - 1:].any() and not got_d[:, n - 1:].any()


def test_neighbors_device_tie_order_on_a_lattice():
    """On an integer lattice every distance is exact and many tie: the
    lower index comes first, as jax.lax.top_k orders ties."""
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coords = (g * 2.0).astype(np.float32)
    want_i, want_d = jneighbors_device(jnp.asarray(coords), 16)
    got_i, got_d = neighbors_device(torch.from_numpy(coords), 16)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    ties = got_d.numpy()[:, 1:] == got_d.numpy()[:, :-1]
    assert ties.any()
    assert np.all(np.diff(got_i.numpy(), axis=1)[ties] > 0)


@pytest.mark.parametrize("n,size,k", [(400, 64, 16), (12, 256, 16), (300, 10, 16)])
def test_fragment_device_matches_jax(n, size, k):
    rng = np.random.default_rng(n + size)
    coords = rng.uniform(0, 25, (n, 3)).astype(np.float32)
    seeds = rng.choice(n, 5, replace=False).astype(np.int32)
    want = [np.asarray(a) for a in jfragment_device(jnp.asarray(coords), jnp.asarray(seeds),
                                                      fragment_size=size, k=k)]
    got = [a.numpy() for a in fragment_device(torch.from_numpy(coords), torch.from_numpy(seeds),
                                              fragment_size=size, k=k)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    members, nbr, dists, weight = got
    np.testing.assert_array_equal(weight, want[3])
    # members by seed distance: the same set, the same order but rounding ties
    d2 = ((coords[members] - coords[seeds][:, None]) ** 2).sum(-1)
    d2_all = np.sort(((coords[None] - coords[seeds][:, None]) ** 2).sum(-1), axis=1)
    d2_all = np.pad(d2_all, ((0, 0), (0, 1)), constant_values=np.inf)[:, :members.shape[1] + 1]
    assert _agree_but_rounding_ties(members, want[0], d2_all) < 0.01
    assert np.all(np.diff(d2, axis=1) > -1e-3)
    same = (members == want[0]).all(1)
    assert same.any()
    # the neighbor lists of fragments with the same members: exact differences
    np.testing.assert_array_equal(nbr[same], want[1][same])
    np.testing.assert_allclose(dists[same], want[2][same], rtol=1e-6, atol=0)
    if size > n:
        kk = min(k, n - 1)
        assert not nbr[..., kk:].any() and not dists[..., kk:].any()


def test_organic_molecules_and_records_match_jax(tmp_path):
    for seed in range(6):
        c_t, e_t = organic.random_molecule(np.random.default_rng(seed))
        c_j, e_j = jorganic.random_molecule(np.random.default_rng(seed))
        np.testing.assert_array_equal(c_t, c_j)
        np.testing.assert_array_equal(e_t, e_j)
    got, want = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    assert organic.write_organic_fragments(got, n_molecules=30, seed=4) == 30
    assert jorganic.write_organic_fragments(want, n_molecules=30, seed=4) == 30
    got_r, want_r = list(read_tfrecord(got)), list(read_tfrecord(want))
    assert len(got_r) == 30 and got_r == want_r
    # append, and molecules small enough to have padding slots
    organic.write_organic_fragments(got, n_molecules=5, seed=5, append=True)
    jorganic.write_organic_fragments(want, n_molecules=5, seed=5, append=True)
    assert open(got, "rb").read() == open(want, "rb").read()
