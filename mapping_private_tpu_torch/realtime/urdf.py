"""URDF robot model → depth image: the robot self-filter's renderer input.

Counterpart of ``mapping_private_tpu/realtime/urdf.py`` (realtime_perception
src/urdf_renderer.cpp:67-135 ``process_link/render``): parse the robot
description, forward-kinematics the link tree for a joint configuration
and rasterise every link's collision mesh into one depth image with
``realtime.render.render_depth_mesh``, the input of
``background_subtract``.  Host numpy apart from the render.

Supports the URDF subset the self-filter needs: fixed, revolute,
continuous and prismatic joints with origin rpy/xyz, per-link
<collision>/<visual> mesh files (binary and ASCII STL, loaded here) or
box/cylinder primitives (meshed by ``fit.box.box_mesh`` and
``fit.cylinder.cylinder_mesh``).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.fit.box import box_mesh
from mapping_private_tpu_torch.fit.cylinder import cylinder_mesh
from mapping_private_tpu_torch.realtime.render import render_depth_mesh
from mapping_private_tpu_torch.utils.device import resolve_device


def _rpy_to_matrix(r: float, p: float, y: float) -> np.ndarray:
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _origin_to_T(el: Optional[ET.Element]) -> np.ndarray:
    T = np.eye(4)
    if el is None:
        return T
    xyz = [float(v) for v in (el.get("xyz") or "0 0 0").split()]
    rpy = [float(v) for v in (el.get("rpy") or "0 0 0").split()]
    T[:3, :3] = _rpy_to_matrix(*rpy)
    T[:3, 3] = xyz
    return T


@dataclasses.dataclass
class Geometry:
    kind: str  # 'mesh' | 'box' | 'cylinder' | 'sphere'
    mesh_file: Optional[str] = None
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    size: Tuple[float, ...] = ()
    origin: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))


@dataclasses.dataclass
class Link:
    name: str
    geometries: List[Geometry] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Joint:
    name: str
    joint_type: str
    parent: str
    child: str
    origin: np.ndarray
    axis: np.ndarray


@dataclasses.dataclass
class RobotModel:
    name: str
    links: Dict[str, Link]
    joints: List[Joint]
    root: str

    def forward_kinematics(
        self, joint_values: Optional[Dict[str, float]] = None
    ) -> Dict[str, np.ndarray]:
        """link name → (4,4) pose in the root frame."""
        jv = joint_values or {}
        poses = {self.root: np.eye(4)}
        remaining = list(self.joints)
        while remaining:
            progressed = False
            for j in list(remaining):
                if j.parent not in poses:
                    continue
                T = poses[j.parent] @ j.origin
                q = float(jv.get(j.name, 0.0))
                if j.joint_type == "revolute" or j.joint_type == "continuous":
                    a = j.axis / max(np.linalg.norm(j.axis), 1e-12)
                    K = np.array([
                        [0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]
                    ])
                    R = np.eye(3) + np.sin(q) * K + (1 - np.cos(q)) * K @ K
                    Tj = np.eye(4)
                    Tj[:3, :3] = R
                    T = T @ Tj
                elif j.joint_type == "prismatic":
                    Tj = np.eye(4)
                    Tj[:3, 3] = j.axis * q
                    T = T @ Tj
                poses[j.child] = T
                remaining.remove(j)
                progressed = True
            if not progressed:
                raise ValueError(
                    f"disconnected joints (parents missing): "
                    f"{[j.name for j in remaining]}"
                )
        return poses


def parse_urdf(path_or_string: str, mesh_root: Optional[str] = None) -> RobotModel:
    if os.path.exists(path_or_string):
        root = ET.parse(path_or_string).getroot()
        mesh_root = mesh_root or os.path.dirname(os.path.abspath(path_or_string))
    else:
        root = ET.fromstring(path_or_string)
        mesh_root = mesh_root or "."
    links: Dict[str, Link] = {}
    for lel in root.findall("link"):
        link = Link(name=lel.get("name", ""))
        for gtag in ("collision", "visual"):
            for cel in lel.findall(gtag):
                geom = cel.find("geometry")
                if geom is None:
                    continue
                origin = _origin_to_T(cel.find("origin"))
                mesh = geom.find("mesh")
                box = geom.find("box")
                cyl = geom.find("cylinder")
                if mesh is not None:
                    fn = mesh.get("filename", "")
                    fn = fn.replace("package://", "")
                    scale = tuple(
                        float(v) for v in (mesh.get("scale") or "1 1 1").split()
                    )
                    link.geometries.append(Geometry(
                        kind="mesh", mesh_file=os.path.join(mesh_root, fn),
                        scale=scale, origin=origin,
                    ))
                elif box is not None:
                    size = tuple(float(v) for v in box.get("size", "0 0 0").split())
                    link.geometries.append(Geometry(kind="box", size=size,
                                                    origin=origin))
                elif cyl is not None:
                    link.geometries.append(Geometry(
                        kind="cylinder",
                        size=(float(cyl.get("radius", 0)), float(cyl.get("length", 0))),
                        origin=origin,
                    ))
            if link.geometries:
                break  # prefer collision geometry; fall back to visual
        links[link.name] = link
    joints = []
    children = set()
    for jel in root.findall("joint"):
        axis_el = jel.find("axis")
        axis = np.asarray(
            [float(v) for v in (axis_el.get("xyz") if axis_el is not None else "1 0 0").split()]
        )
        j = Joint(
            name=jel.get("name", ""), joint_type=jel.get("type", "fixed"),
            parent=jel.find("parent").get("link"),
            child=jel.find("child").get("link"),
            origin=_origin_to_T(jel.find("origin")), axis=axis,
        )
        joints.append(j)
        children.add(j.child)
    roots = [n for n in links if n not in children]
    return RobotModel(name=root.get("name", "robot"), links=links,
                      joints=joints, root=roots[0] if roots else next(iter(links)))


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Binary or ASCII STL → (vertices (V,3), triangles (T,3))."""
    with open(path, "rb") as fp:
        head = fp.read(5)
        fp.seek(0)
        data = fp.read()
    if head[:5].lower() == b"solid" and b"facet" in data[:1000]:
        # ascii
        verts = []
        for line in data.decode("ascii", errors="replace").splitlines():
            line = line.strip()
            if line.startswith("vertex"):
                verts.append([float(v) for v in line.split()[1:4]])
        v = np.asarray(verts, np.float32).reshape(-1, 3)
    else:
        n = struct.unpack("<I", data[80:84])[0]
        rec = np.frombuffer(data[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
        tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
        v = tri.reshape(-1, 3).astype(np.float32)
    t = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    return v, t


def _geometry_mesh(g: Geometry) -> Tuple[np.ndarray, np.ndarray]:
    if g.kind == "mesh":
        v, t = load_stl(g.mesh_file)
        v = v * np.asarray(g.scale, np.float32)
    elif g.kind == "box":
        v, t = box_mesh(np.zeros(3), np.eye(3), np.asarray(g.size))
    elif g.kind == "cylinder":
        r, length = g.size
        v, t = cylinder_mesh(np.zeros(3), np.array([0, 0, 1.0]), r,
                             -length / 2, length / 2)
    else:
        raise ValueError(f"unsupported geometry {g.kind}")
    # apply the geometry's local origin
    v = v @ g.origin[:3, :3].T + g.origin[:3, 3]
    return v.astype(np.float32), t


def render_robot_depth(
    robot: RobotModel,
    camera_from_root: np.ndarray,
    image_shape: Tuple[int, int] = (480, 640),
    fx: float = 525.0,
    fy: float = 525.0,
    joint_values: Optional[Dict[str, float]] = None,
    *,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """One (H, W) depth image of the whole robot (the URDFRenderer FBO
    pass), rendered on ``device``: forward-kinematics each link, move its
    meshes into the camera frame on the host, rasterise all triangles in
    one call.  Returns numpy, 0 where the robot is not seen."""
    device = resolve_device(device)
    poses = robot.forward_kinematics(joint_values)
    all_v, all_t = [], []
    off = 0
    cam = np.asarray(camera_from_root, np.float64)
    for name, link in robot.links.items():
        if name not in poses:
            continue
        T = cam @ poses[name]
        for g in link.geometries:
            v, t = _geometry_mesh(g)
            v = v @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32)
            all_v.append(v)
            all_t.append(t + off)
            off += len(v)
    if not all_v:
        return np.zeros(image_shape, np.float32)
    verts = torch.from_numpy(np.concatenate(all_v)).to(device)
    tris = torch.from_numpy(np.concatenate(all_t)).to(device)
    return render_depth_mesh(verts, tris, image_shape, fx=fx, fy=fy).cpu().numpy()
