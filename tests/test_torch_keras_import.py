"""The port's importer of the reference's Keras checkpoint against the JAX
package's: a checkpoint synthesized as tests/test_keras_import.py writes
one, read by both importers, gives the same parameters and config and the
same forward."""
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from nmrgnn_tpu import ModelConfig as JModelConfig  # noqa: E402
from nmrgnn_tpu import apply as japply  # noqa: E402
from nmrgnn_tpu.compat import import_reference_checkpoint as jimport  # noqa: E402
from nmrgnn_tpu.graph import Graph as JGraph  # noqa: E402
from nmrgnn_tpu_torch.compat import import_reference_checkpoint  # noqa: E402
from nmrgnn_tpu_torch.graph import Graph  # noqa: E402
from nmrgnn_tpu_torch.models import gnn  # noqa: E402

from test_keras_import import make_reference_style_checkpoint  # noqa: E402
from test_model import rand_graph  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(atom_feature_size=32, edge_hidden_size=16, edge_feature_size=3, mp_layers=2,
         fc_layers=3, edge_fc_layers=3),
    dict(atom_feature_size=64, edge_hidden_size=32, edge_feature_size=8, mp_layers=1,
         fc_layers=2, edge_fc_layers=2),
])
def test_import_matches_jax(tmp_path, kw):
    cfg = JModelConfig(num_elements=10, dropout=False, noise=0.0, **kw)
    prefix = make_reference_style_checkpoint(tmp_path, cfg, seed=3)
    jparams, jcfg = jimport(prefix)
    params, tcfg = import_reference_checkpoint(prefix, device="cpu")
    assert tcfg.to_json() == jcfg.to_json()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    got = [t.numpy() for t in gnn.tree_leaves(params)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    g = rand_graph(np.random.default_rng(7))
    jout = np.asarray(japply(jparams, jcfg, JGraph(*g)))
    tout = gnn.apply(params, tcfg, Graph(*[torch.as_tensor(np.array(a)) for a in g]))
    np.testing.assert_allclose(tout.numpy(), jout, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):  # a config that disagrees with the shapes
        import_reference_checkpoint(prefix, config=tcfg.__class__(atom_feature_size=16),
                                    device="cpu")
