"""The port's subpackages re-export what the JAX package's do, every
module of the JAX package has a counterpart, and the two functions that
were missing from done modules match.

For each subpackage the port's ``__all__`` must equal the JAX
``__all__`` minus the names listed in NOT_YET_PORTED: porting a name
without taking it off the list fails, and so does taking it off the list
before the port exports it.  Every exported name must resolve."""
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapping_private_tpu.core import se3 as jse3
from mapping_private_tpu.io import pcd as jpcd
from mapping_private_tpu_torch.core import se3 as tse3
from mapping_private_tpu_torch.io import pcd as tpcd

NOT_YET_PORTED = {
    "core": set(),
    "io": set(),
    "models": set(),
    "ops": set(),
    "fit": set(),
    "registration": set(),
    "parallel": set(),
    "features": set(),
    "recognition": set(),
    "classify": set(),
    "realtime": set(),
    "pipeline": set(),
    "integration": set(),
    "native": set(),
    "utils": set(),
}


REPO = pathlib.Path(__file__).resolve().parent.parent
# the JAX module whose three Pallas kernels live in three port modules
KERNEL_MODULES = {"ops/pallas_nn.py": {"ops/nn_argmin.py", "ops/nn_matmul.py", "ops/nn_gather.py"}}


def _modules(pkg):
    return {str(p.relative_to(REPO / pkg)) for p in (REPO / pkg).rglob("*.py") if p.name != "__init__.py"}


def test_every_module_has_a_counterpart():
    jax_mods, port_mods = _modules("mapping_private_tpu"), _modules("mapping_private_tpu_torch")
    assert len(jax_mods) == 72
    missing = {m for m in jax_mods if m not in port_mods and not KERNEL_MODULES.get(m, {m}) <= port_mods}
    assert missing == set()


def test_every_subpackage_is_mirrored():
    subs = {p.parent.name for p in (REPO / "mapping_private_tpu").glob("*/__init__.py")} - {"apps"}
    assert subs == set(NOT_YET_PORTED) and len(subs) == 15


@pytest.mark.parametrize("sub", sorted(NOT_YET_PORTED))
def test_all_mirrors_the_jax_package(sub):
    jmod = importlib.import_module(f"mapping_private_tpu.{sub}")
    tmod = importlib.import_module(f"mapping_private_tpu_torch.{sub}")
    assert NOT_YET_PORTED[sub] <= set(jmod.__all__), "a listed name the JAX package does not export"
    assert set(tmod.__all__) == set(jmod.__all__) - NOT_YET_PORTED[sub]
    assert len(tmod.__all__) == len(set(tmod.__all__))
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None


def test_documented_imports():
    from mapping_private_tpu_torch.core import PointCloud
    from mapping_private_tpu_torch.io import load_pcd
    from mapping_private_tpu_torch.models import detect_table
    from mapping_private_tpu_torch.ops import voxel_downsample

    assert PointCloud.__module__ == "mapping_private_tpu_torch.core.cloud"
    assert load_pcd.__module__ == "mapping_private_tpu_torch.io.pcd"
    assert detect_table.__module__ == "mapping_private_tpu_torch.models.table_detector"
    assert voxel_downsample.__module__ == "mapping_private_tpu_torch.ops.voxel"

    from mapping_private_tpu_torch.classify import SVMModel, classify_subspace, train_subspaces
    from mapping_private_tpu_torch.core import VoxelGrid
    from mapping_private_tpu_torch.features import colorchlac117_subdiv, vosch, voxel_types
    from mapping_private_tpu_torch.recognition import PCAResult, build_scene_data, search_object

    from mapping_private_tpu_torch.integration import JloRegistry
    from mapping_private_tpu_torch.io import parse_semantic_map, read_vtk_mesh, write_dxf_mesh
    from mapping_private_tpu_torch.native import parse_floats
    from mapping_private_tpu_torch.pipeline import Pipeline
    from mapping_private_tpu_torch.realtime import multi_plane_ransac, render_robot_depth
    from mapping_private_tpu_torch.utils import Metrics

    for obj, module in ((JloRegistry, "integration.services"), (parse_semantic_map, "io.semantic_map"),
                        (read_vtk_mesh, "io.mesh"), (write_dxf_mesh, "io.dxf"), (parse_floats, "native.loader"),
                        (Pipeline, "pipeline.dag"), (multi_plane_ransac, "realtime.segmentation"),
                        (render_robot_depth, "realtime.urdf"), (Metrics, "utils.metrics")):
        assert obj.__module__ == f"mapping_private_tpu_torch.{module}"
    for obj, module in ((VoxelGrid, "core.voxelgrid"), (colorchlac117_subdiv, "features.colorchlac"),
                        (vosch, "features.rsd"), (voxel_types, "features.extract"), (PCAResult, "recognition.pca"),
                        (build_scene_data, "recognition.search"), (search_object, "recognition.search"),
                        (SVMModel, "classify.libsvm"), (train_subspaces, "classify.subspace"),
                        (classify_subspace, "classify.subspace")):
        assert obj.__module__ == f"mapping_private_tpu_torch.{module}"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_se3_identity_matches(dtype):
    got = tse3.se3_identity(getattr(torch, dtype))
    want = np.asarray(jse3.se3_identity(getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, 4)
    np.testing.assert_array_equal(got.numpy(), want.astype(dtype))
    assert torch.equal(tse3.se3_compose(got, tse3.se3_exp(torch.tensor([0.1, 0.2, 0.3, 0.01, 0.02, 0.03],
                                                                        dtype=getattr(torch, dtype)))),
                       tse3.se3_exp(torch.tensor([0.1, 0.2, 0.3, 0.01, 0.02, 0.03], dtype=getattr(torch, dtype))))


def test_pack_rgb_matches_and_round_trips():
    rng = np.random.default_rng(0)
    r, g, b = (rng.integers(0, 256, 500).astype(np.float32) for _ in range(3))
    r[:3] = [-5.0, 300.0, 255.0]  # clipped into [0, 255]
    got, want = tpcd.pack_rgb(r, g, b), jpcd.pack_rgb(r, g, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    r2, g2, b2 = tpcd._unpack_rgb(got)
    np.testing.assert_array_equal(r2, np.clip(r, 0, 255))
    np.testing.assert_array_equal(g2, g)
    np.testing.assert_array_equal(b2, b)
