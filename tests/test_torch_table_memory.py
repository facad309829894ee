"""Port parity: models/table_memory.py against the JAX package on
tests/test_pipeline_memory.py's clusters and table hulls.

``_reconstruct_object`` is compared with the cylinder RANSAC's uniforms
carried across: the same type and fit quality (within 1e-3: the inlier
fraction of a few hundred points, up to points on the threshold), the
cylinder within 1e-3 and the box within 1e-4 (MLS and the fits round
differently across the libraries).  ``update`` draws from its own
generator, so over a sequence of observations the table matching,
polygons, object centres and names must be equal and the types the same.
A checkpoint written by either package restores in the other with an
equal ``belief_state()``: the ``.npz`` layout is shared."""
import jax
import numpy as np
import pytest
import torch
from test_pipeline_memory import _box_points, _cylinder_points

from mapping_private_tpu.models import table_memory as jtm
from mapping_private_tpu_torch.models import table_memory as ttm


def _hull(cx, cy, w=0.8, h=0.6):
    return np.array([[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                     [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]])


@pytest.mark.parametrize("points", [_cylinder_points(), _box_points(), _cylinder_points(n=10)],
                         ids=["cylinder", "box", "too_few_points"])
def test_reconstruct_object_matches(points):
    key = jax.random.PRNGKey(11)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (ttm.CYLINDER_HYPOTHESES, 2))))
    jo = jtm._reconstruct_object(points, key)
    to = ttm._reconstruct_object(points, None, device="cpu", u=u)
    assert to.object_type == jo.object_type
    assert to.fit_quality == pytest.approx(jo.fit_quality, abs=1e-3)
    np.testing.assert_array_equal(to.center, jo.center)
    assert (to.cylinder is None) == (jo.cylinder is None)
    for k in (jo.cylinder or {}):
        np.testing.assert_allclose(to.cylinder[k], jo.cylinder[k], rtol=0, atol=1e-3)
    assert (to.box is None) == (jo.box is None)
    for k in (jo.box or {}):
        np.testing.assert_allclose(to.box[k], jo.box[k], rtol=0, atol=1e-4)


def _observations():
    """A table seen three times (shifted), its objects moving a little, a
    second table far away, and one object that turns up elsewhere."""
    cyl, box = _cylinder_points, _box_points
    return [
        (_hull(1.0, 2.0), 0.75, [cyl(center=(1.1, 2.1)), box(center=(0.8, 1.9))]),
        (_hull(1.05, 2.02), 0.75, [box(center=(0.81, 1.9), seed=5), cyl(center=(1.1, 2.11), seed=3)]),
        (_hull(5.0, 5.0), 0.9, [cyl(center=(5.0, 5.1), seed=9)]),
        (_hull(1.02, 2.0), 0.75, [cyl(center=(1.3, 2.2), seed=8)]),
    ]


def _feed(mem, port):
    ids = []
    for stamp, (hull, height, clusters) in enumerate(_observations()):
        kw = dict(generator=torch.Generator().manual_seed(stamp)) if port else dict(key=jax.random.PRNGKey(stamp))
        ids.append(mem.update(hull, height, clusters, stamp=float(stamp), **kw))
    return ids


def _strip(belief):
    """The belief state without fit_quality (random draws differ)."""
    return {t: [{k: v for k, v in o.items() if k != "fit_quality"} for o in objs] for t, objs in belief.items()}


def test_update_sequence_matches():
    jm, tm = jtm.TableMemory(), ttm.TableMemory(device="cpu")
    assert _feed(tm, True) == _feed(jm, False) == [0, 0, 1, 0]
    assert _strip(tm.belief_state()) == _strip(jm.belief_state())
    for jt, tt in zip(jm.tables, tm.tables):
        np.testing.assert_array_equal(tt.polygon, jt.polygon)
        np.testing.assert_array_equal(tt.center, jt.center)
        assert [len(i.objects) for i in tt.instances] == [len(i.objects) for i in jt.instances]
    names = [[o.name for o in i.objects] for i in tm.tables[0].instances]
    assert names == [["object_0", "object_1"], ["object_1", "object_0"], ["object_3"]]


def test_tables_match_and_classify_fn():
    a, b = _hull(0, 0), _hull(0.3, 0.1)
    for old, new in ((a, b), (a, _hull(3, 3)), (a[:2], b)):
        c = new.mean(0)
        assert ttm.tables_match(old, 0.48, new, c) == jtm.tables_match(old, 0.48, new, c)
    mem = ttm.TableMemory(classify_fn=lambda p: "tall" if np.ptp(p[:, 2]) > 0.1 else 1 / 0, device="cpu")
    mem.update(_hull(0, 0), 0.7, [_cylinder_points(h=0.15), _cylinder_points(h=0.02, center=(0.7, 0.6))])
    assert sorted(o.semantic_class for o in mem.tables[0].latest().objects) == ["", "tall"]


def test_checkpoint_restores_across_packages(tmp_path):
    jm, tm = jtm.TableMemory(), ttm.TableMemory(device="cpu")
    _feed(jm, False)
    _feed(tm, True)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jm.checkpoint(jpath)
    tm.checkpoint(tpath)
    back_t = ttm.TableMemory.restore(jpath, device="cpu")
    back_j = jtm.TableMemory.restore(tpath)
    assert back_t.belief_state() == jm.belief_state()
    assert back_j.belief_state() == tm.belief_state()
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
    # the restored memories go on matching and naming alike
    obs = (_hull(1.0, 2.01), 0.75, [_cylinder_points(center=(1.3, 2.2), seed=12)])
    assert back_t.update(*obs, stamp=9.0) == back_j.update(*obs, stamp=9.0, key=jax.random.PRNGKey(9)) == 0
    assert _strip(back_t.belief_state()) == _strip(back_j.belief_state())
    assert back_t.tables[0].latest().objects[0].name == "object_3"  # seen there before
