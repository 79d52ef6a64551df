"""Large-mesh building blocks: midpoint subdivision (models/subdivide.py)
and the seeded stand-in meshes built on it (models/blob.py), which take the
place of the reference's scanned bunny and modelled teapot."""

import numpy as np
import pytest

from torrey.models.blob import blob_mesh
from torrey.models.ir import ParsedTriangleMesh
from torrey.models.subdivide import subdivide_mesh


def test_subdivide_preserves_surface():
    """1:4 split: area and bbox preserved, vertex dedup works."""
    mesh = ParsedTriangleMesh(
        material_id=0,
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                           np.float32),
        indices=np.array([[0, 1, 2], [1, 3, 2]], np.int32))
    out = subdivide_mesh(mesh, levels=2)
    assert out.indices.shape[0] == 2 * 16
    # shared-edge midpoints deduplicated: Euler count for a 2-tri quad
    # subdivided twice = 25 grid vertices
    assert out.positions.shape[0] == 25

    def area(m):
        p = m.positions[m.indices]
        return 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1).sum()

    assert np.isclose(area(out), area(mesh), rtol=1e-6)
    assert np.allclose(out.positions.min(0), mesh.positions.min(0))
    assert np.allclose(out.positions.max(0), mesh.positions.max(0))


@pytest.mark.parametrize("n", [1, 7, 40, 6320, 144046])
def test_blob_mesh_has_exact_triangle_count(n):
    mesh = blob_mesh(3, n)
    assert mesh.indices.shape == (n, 3)
    V = mesh.positions.shape[0]
    # every vertex is used and every index is in range
    assert np.array_equal(np.unique(mesh.indices), np.arange(V))
    assert mesh.normals.shape == (V, 3) and mesh.uvs.shape == (V, 2)
    assert np.isfinite(mesh.positions).all()


def test_blob_mesh_is_deterministic_per_seed():
    a, b = blob_mesh(7, 5000), blob_mesh(7, 5000)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.indices, b.indices)
    c = blob_mesh(8, 5000)
    assert not np.array_equal(a.positions, c.positions)


def test_blob_mesh_is_cut_from_below():
    """Triangles are removed from the bottom up: every kept triangle's
    lowest corner is at or above every dropped one's."""
    full = blob_mesh(5, 2 * 20 * 4 ** 3)       # two whole level-3 parts
    cut = blob_mesh(5, 2000)
    assert full.positions[:, 1].min() < cut.positions[:, 1].min()
    np.testing.assert_allclose(full.positions.max(0), cut.positions.max(0))


def test_blob_mesh_rejects_empty():
    with pytest.raises(ValueError):
        blob_mesh(0, 0)
