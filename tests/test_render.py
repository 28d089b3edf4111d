"""Offline software renderer (utils/render.py) — the render-export
counterpart of the reference's Polyscope viewer (`src/visualise.cpp:29-197`)."""

import numpy as np
import pytest

from pbf_sph_tpu.core.types import ColouredMesh
from pbf_sph_tpu.utils import render as R


def _tri_mesh():
    vs = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                   [0, 0, 0.5], [1, 0, 0.5], [0, 1, 0.5]], np.float32)
    ns = np.tile(np.array([[0, 0, 1]], np.float32), (6, 1))
    cs = np.tile(np.array([[0.2, 0.4, 0.9, 1.0]], np.float32), (6, 1))
    return ColouredMesh(vs, ns, cs)


def test_render_mesh_covers_pixels_and_depth_orders():
    m = _tri_mesh()
    img, zbuf = R.render_mesh(m.vs, m.ns, m.cs, width=160, height=120)
    assert img.shape == (120, 160, 3)
    covered = np.isfinite(zbuf)
    assert covered.sum() > 200  # the triangles actually rasterized
    # the front triangle (z=0.5 slab is closer to the default +z-ish eye)
    # must win the z-test: every covered pixel holds a finite depth
    assert (zbuf[covered] > 0).all()
    # deterministic: identical input -> identical image
    img2, _ = R.render_mesh(m.vs, m.ns, m.cs, width=160, height=120)
    np.testing.assert_array_equal(img, img2)


def test_render_points_and_compositing(tmp_path):
    pos = np.random.default_rng(0).uniform(0, 1, (500, 3))
    col = np.tile(np.array([[1.0, 0.2, 0.1, 1.0]]), (500, 1))
    img, zbuf = R.render_points(pos, col, width=128, height=96, radius=2)
    assert (np.isfinite(zbuf)).sum() > 100
    out = tmp_path / "cloud.png"
    R.save_png(out, img)
    assert out.exists() and out.stat().st_size > 100


def test_render_frame_and_obj_roundtrip(tmp_path):
    m = _tri_mesh()
    png = tmp_path / "f.png"
    R.render_frame(png, mesh=m, width=100, height=80)
    assert png.exists()
    from pbf_sph_tpu.utils.export import save_obj_mesh

    obj = tmp_path / "m.obj"
    save_obj_mesh(obj, m)
    vs, ns = R.load_obj_mesh(obj)
    np.testing.assert_allclose(vs, m.vs, atol=1e-5)
    np.testing.assert_allclose(ns, m.ns, atol=1e-5)


def test_render_frame_empty_raises(tmp_path):
    with pytest.raises(ValueError):
        R.render_frame(tmp_path / "x.png", mesh=None, xs=None)


def test_render_mesh_oversized_triangle_has_no_holes():
    """A close-up triangle whose screen bbox far exceeds max_block must be
    tiled, not clipped (the old policy clipped to one 64px
    block and rendered holes)."""
    # one huge triangle facing the camera, framed to fill the viewport
    vs = np.array([[-10, -10, 0], [10, -10, 0], [0, 14, 0]], np.float64)
    ns = np.tile(np.array([[0, 0, 1.0]]), (3, 1))
    cs = np.tile(np.array([[0.9, 0.2, 0.2, 1.0]]), (3, 1))
    W, H = 320, 240
    img, zbuf = R.render_mesh(vs, ns, cs, width=W, height=H, max_block=64)
    covered = np.isfinite(zbuf)
    # the old clipping policy capped coverage at one 64x64 block (4096 px)
    assert covered.sum() > 64 * 64
    # tiled (max_block=64) must be pixel-identical to a block big enough to
    # skip the tiling path entirely
    img_ref, zbuf_ref = R.render_mesh(vs, ns, cs, width=W, height=H,
                                      max_block=512)
    np.testing.assert_array_equal(img, img_ref)
    np.testing.assert_array_equal(zbuf, zbuf_ref)


def test_render_frame_composites_mesh_and_cloud(tmp_path):
    """Mesh + point cloud share one z-buffer (the reference viewer draws
    both every frame, src/visualise.cpp:152-179): adding a cloud in front
    of the mesh must change the image."""
    from pbf_sph_tpu.core.types import ParticleSoA

    m = _tri_mesh()
    rng = np.random.default_rng(1)
    n = 200
    xs = ParticleSoA(
        pid=np.arange(n), ptype=np.zeros(n, np.int32),
        mass=np.ones(n, np.float32),
        position=rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32) + [0, 0, 2.0],
        velocity=np.zeros((n, 3), np.float32),
        colour=np.tile(np.array([[1.0, 0.9, 0.1, 1.0]], np.float32), (n, 1)),
    )
    p_mesh = tmp_path / "mesh_only.png"
    p_both = tmp_path / "both.png"
    center = np.array([0.5, 0.5, 1.0])
    R.render_frame(p_mesh, mesh=m, width=160, height=120,
                   center=center, radius=2.0)
    R.render_frame(p_both, mesh=m, xs=xs, width=160, height=120,
                   center=center, radius=2.0)
    from PIL import Image

    a = np.asarray(Image.open(p_mesh))
    b = np.asarray(Image.open(p_both))
    assert a.shape == b.shape
    assert (a != b).any()  # the cloud splats are visible over/next to the mesh
