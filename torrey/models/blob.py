"""Seeded stand-in meshes for the scanned models the corpus cannot ship.

The reference's teapot and bunny are modelled or scanned data that this
repository does not carry.  Their stand-ins are generated at load time from
a seed: two icospheres (a body and a smaller head) refined with
:func:`.subdivide.subdivide_mesh`, pushed onto a lumpy surface by a seeded
sum of sine waves over the unit direction, and then cut from below until
exactly ``num_triangles`` remain.  The cut leaves an open base, as the
bunny scan has.  The same seed and count always give the same mesh, so a
scene XML (``<shape type="blob">``) names the mesh by those two integers.
"""

from __future__ import annotations

import numpy as np

from ..utils.math3d import compute_vertex_normals
from .ir import ParsedTriangleMesh
from .subdivide import subdivide_mesh

_PHI = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_VERTS = np.array([
    [-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
    [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
    [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]], np.float64)
_ICO_FACES = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

# (center, radius) of the body and the head, in object space
_PARTS = (((0.0, 0.0, 0.0), 1.0), ((0.75, 0.8, 0.0), 0.55))
_WAVES = 8          # sine terms of the radial displacement
_AMPLITUDE = 0.12   # displacement relative to the part's radius


def _icosphere(levels: int):
    mesh = ParsedTriangleMesh(positions=_ICO_VERTS.astype(np.float32),
                              indices=_ICO_FACES.astype(np.int32))
    mesh = subdivide_mesh(mesh, levels)
    pos = mesh.positions.astype(np.float64)
    return pos / np.linalg.norm(pos, axis=1, keepdims=True), mesh.indices


def blob_mesh(seed: int, num_triangles: int) -> ParsedTriangleMesh:
    """Closed-form stand-in mesh with exactly ``num_triangles`` triangles,
    smooth vertex normals and spherical uvs."""
    if num_triangles < 1:
        raise ValueError(f"num_triangles must be positive: {num_triangles}")
    per_part = -(-num_triangles // len(_PARTS))
    levels = 0
    while 20 * 4 ** levels < per_part:
        levels += 1
    unit, faces = _icosphere(levels)
    rng = np.random.default_rng(seed)

    positions, indices, uvs = [], [], []
    for k, (center, radius) in enumerate(_PARTS):
        freq = rng.normal(size=(_WAVES, 3)) * 2.5
        phase = rng.uniform(0.0, 2.0 * np.pi, _WAVES)
        weight = rng.uniform(0.3, 1.0, _WAVES)
        bump = (np.sin(unit @ freq.T + phase) * weight).sum(axis=1)
        r = radius * (1.0 + _AMPLITUDE * bump / weight.sum())
        positions.append(np.asarray(center) + unit * r[:, None])
        indices.append(faces + k * len(unit))
        uvs.append(np.stack([np.arctan2(unit[:, 2], unit[:, 0]) / (2 * np.pi)
                             + 0.5,
                             np.arccos(np.clip(unit[:, 1], -1, 1)) / np.pi],
                            axis=1))
    pos = np.concatenate(positions)
    idx = np.concatenate(indices)
    uv = np.concatenate(uvs)

    # cut from below: keep the num_triangles faces whose lowest corner is
    # highest (a stable sort keeps ties in index order, so the cut is
    # deterministic)
    low = pos[idx, 1].min(axis=1)
    keep = np.sort(np.argsort(-low, kind="stable")[:num_triangles])
    idx = idx[keep]
    used, idx = np.unique(idx, return_inverse=True)
    idx = idx.reshape(-1, 3)

    pos = pos[used].astype(np.float32)
    return ParsedTriangleMesh(positions=pos, indices=idx.astype(np.int32),
                              normals=compute_vertex_normals(pos, idx),
                              uvs=uv[used].astype(np.float32))
