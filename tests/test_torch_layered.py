"""Port parity: models/layered_reconstruction.py against the JAX package
on tests/test_layered.py's scene (a wall and an r = 0.1 cylinder), each
fitted layer's line and circle uniforms carried across from the JAX key
chain (``tests/jax_ref.py::layered_uniforms``): the same solids, kinds,
layers and z ranges equal, parameters within 1e-5."""
import jax
import numpy as np
import pytest
import torch
from jax_ref import layered_uniforms, one_torch_thread  # noqa: F401 (fixture)
from test_layered import _scene

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.models import layered_reconstruction as jl
from mapping_private_tpu_torch.core import PointCloud
from mapping_private_tpu_torch.models import layered_reconstruction as tl

CFG = dict(layer_height=0.1, min_inliers=40, num_hypotheses=128)


def _assert_same_solids(st, sj):
    assert [(s.kind, s.layers) for s in st] == [(s.kind, s.layers) for s in sj]
    for a, b in zip(st, sj):
        assert (a.z_lo, a.z_hi) == pytest.approx((b.z_lo, b.z_hi), abs=1e-6)
        assert a.params.keys() == b.params.keys()
        for k in a.params:
            np.testing.assert_allclose(np.asarray(a.params[k]), np.asarray(b.params[k]), rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("seed,key", [(0, 0), (1, 3)])
def test_layered_matches_jax(seed, key):
    pts = _scene(seed)
    k = jax.random.PRNGKey(key)
    sj = jl.layered_reconstruction(JCloud.from_numpy(pts), k, jl.LayeredConfig(**CFG))
    u = [tuple(torch.tensor(a) for a in pair) for pair in layered_uniforms(k, 8, CFG["num_hypotheses"])]
    st = tl.layered_reconstruction(PointCloud.from_numpy(pts, device="cpu"), cfg=tl.LayeredConfig(**CFG), u=u)
    _assert_same_solids(st, sj)
    kinds = {s.kind for s in st}
    assert kinds == {"box", "cylinder"}
    cyl = next(s for s in st if s.kind == "cylinder")
    np.testing.assert_allclose(cyl.params["center"], [2.0, 1.5], atol=0.02)
    assert abs(cyl.params["radius"] - 0.1) < 0.01 and cyl.z_hi - cyl.z_lo >= 0.3


def test_layered_with_generator_and_empty():
    st = tl.layered_reconstruction(PointCloud.from_numpy(_scene(2), device="cpu"), torch.Generator().manual_seed(0))
    assert {s.kind for s in st} == {"box", "cylinder"}
    box = next(s for s in st if s.kind == "box")
    e0, e1 = np.asarray(box.params["endpoints"])
    assert np.linalg.norm(e1 - e0) > 0.8
    empty = PointCloud.from_numpy(np.zeros((0, 3), np.float32), device="cpu")
    assert tl.layered_reconstruction(empty, torch.Generator().manual_seed(1)) == []
