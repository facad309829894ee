"""Semantic-map XML parsing (host numpy).

Counterpart of ``mapping_private_tpu/io/semantic_map.py`` (the reference's
xml_to_semantic_map parser, xml_semantic_map_parser.h, and the marker
conversion of src/semantic_map_to_marker.cpp): parses the CAD kitchen
SemanticMap XML (walls, horizontal surfaces, handles, knobs and furniture
candidates with faces) into typed records, and turns them into boxes (the
RViz-marker analogue).  The corner-frame fix of
src/xml_to_semantic_map.cpp:36-60 is ``corner_frame_offset``.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np


def _vec(text: str) -> np.ndarray:
    return np.asarray([float(v) for v in text.split()], np.float64)


@dataclasses.dataclass
class PlanarEntity:
    """A wall or horizontal surface: plane model + axis-aligned span."""

    name: str
    entity_id: int
    kind: str  # 'wall' | 'horizontal'
    model: np.ndarray  # (4,) plane coefficients
    min_d: np.ndarray  # (3,)
    max_d: np.ndarray  # (3,)


@dataclasses.dataclass
class Handle:
    name: str
    entity_id: int
    center: np.ndarray
    elongation: np.ndarray
    door_id: int


@dataclasses.dataclass
class Knob:
    name: str
    entity_id: int
    center: np.ndarray
    radius: float
    door_id: int


@dataclasses.dataclass
class Face:
    side: str
    points: List[np.ndarray]


@dataclasses.dataclass
class Candidate:
    """A furniture candidate (drawer/door/appliance) with its faces."""

    name: str
    entity_id: int
    type_id: int
    type_name: str
    wall_id: int
    faces: List[Face]


@dataclasses.dataclass
class SemanticMap:
    walls: List[PlanarEntity]
    horizontals: List[PlanarEntity]
    handles: List[Handle]
    knobs: List[Knob]
    candidates: List[Candidate]

    def by_id(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for group in (self.walls, self.horizontals, self.handles,
                      self.knobs, self.candidates):
            for e in group:
                out[e.entity_id] = e
        return out


def parse_semantic_map(path: str) -> SemanticMap:
    root = ET.parse(path).getroot()
    walls, horizontals, handles, knobs, candidates = [], [], [], [], []
    for el in root:
        tag = el.tag.lower()
        name = el.get("name", "")
        eid = int(el.get("id", "-1"))
        if tag in ("wall", "horizontal"):
            ent = PlanarEntity(
                name=name, entity_id=eid, kind=tag,
                model=_vec(el.findtext("model", "0 0 0 0")),
                min_d=_vec(el.findtext("minD", "0 0 0")),
                max_d=_vec(el.findtext("maxD", "0 0 0")),
            )
            (walls if tag == "wall" else horizontals).append(ent)
        elif tag == "handle":
            handles.append(Handle(
                name=name, entity_id=eid,
                center=_vec(el.findtext("center", "0 0 0")),
                elongation=_vec(el.findtext("elongation", "0 0 0")),
                door_id=int(el.findtext("doorID", "-1")),
            ))
        elif tag == "knob":
            knobs.append(Knob(
                name=name, entity_id=eid,
                center=_vec(el.findtext("center", "0 0 0")),
                radius=float(el.findtext("radius", "0")),
                door_id=int(el.findtext("doorID", "-1")),
            ))
        elif tag == "candidate":
            faces = []
            for f in el.findall("face"):
                pts = [_vec(p.text) for p in f if p.text]
                faces.append(Face(side=f.get("side", ""), points=pts))
            candidates.append(Candidate(
                name=name, entity_id=eid,
                type_id=int(el.get("type", "-1")),
                type_name=el.get("typename", ""),
                wall_id=int(el.findtext("wallID", "-1")),
                faces=faces,
            ))
    return SemanticMap(walls=walls, horizontals=horizontals, handles=handles,
                       knobs=knobs, candidates=candidates)


def corner_frame_offset(smap: SemanticMap) -> np.ndarray:
    """Translation putting the map's min corner at the origin
    (xml_to_semantic_map.cpp:36-60 frame fix)."""
    pts = []
    for e in smap.walls + smap.horizontals:
        pts.append(e.min_d)
        pts.append(e.max_d)
    if not pts:
        return np.zeros(3)
    return -np.min(np.stack(pts), axis=0)


def map_to_boxes(smap: SemanticMap, thickness: float = 0.02) -> List[dict]:
    """Renderable boxes (the semantic_map_to_marker.cpp CUBE markers):
    planar entities become thin slabs, handles elongated boxes."""
    boxes = []
    for e in smap.walls + smap.horizontals:
        lo = np.minimum(e.min_d, e.max_d)
        hi = np.maximum(e.min_d, e.max_d)
        size = np.maximum(hi - lo, thickness)
        boxes.append(dict(
            name=e.name, kind=e.kind,
            center=((lo + hi) / 2).tolist(), size=size.tolist(),
        ))
    for h in smap.handles:
        boxes.append(dict(
            name=h.name, kind="handle", center=h.center.tolist(),
            size=(2 * h.elongation).tolist(),
        ))
    return boxes
