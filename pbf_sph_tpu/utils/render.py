"""Offline software renderer — turntable PNGs from exported meshes/clouds.

The reference ships a live Polyscope/ImGui viewer (reference
`src/visualise.cpp:29-197`, mesh adapter `src/polyscope_extra.cpp:10-48`);
a headless accelerator host has no GL surface, so the render-export pipeline
(`visualise.py`) is completed here by an actual renderer: a deterministic
NumPy z-buffer rasterizer (no GL, no display) that turns the per-frame
triangle soup / point cloud into shaded PNGs.

Design: fragments are generated vectorized per triangle-batch (each triangle
rasterizes a PxP candidate block around its screen bbox; MC triangles are
near-uniform in world space so P stays small), then depth-resolved in one
lexsort — a classic scatter/sort formulation of the z-buffer that needs no
per-pixel loop.  Gouraud shading with a headlight + hemisphere ambient.
"""

from __future__ import annotations

import numpy as np


def _normalize(v, axis=-1):
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-20)


def look_at(eye, center, up=(0.0, 1.0, 0.0)):
    """Camera rotation R (world->cam rows) and eye position."""
    eye = np.asarray(eye, np.float64)
    f = _normalize(np.asarray(center, np.float64) - eye)
    r = _normalize(np.cross(f, np.asarray(up, np.float64)))
    u = np.cross(r, f)
    return np.stack([r, u, -f]), eye


def project(verts, R, eye, fov_deg, width, height):
    """World (N,3) -> screen (sx, sy, depth) with a standard perspective.

    depth is the camera-space distance along -z (larger = farther); points
    behind the near plane get depth=inf (never win the z-test)."""
    cam = (np.asarray(verts, np.float64) - eye) @ R.T
    z = -cam[:, 2]
    near = 1e-6
    zc = np.maximum(z, near)
    focal = 0.5 * height / np.tan(np.radians(fov_deg) * 0.5)
    sx = width * 0.5 + cam[:, 0] / zc * focal
    sy = height * 0.5 - cam[:, 1] / zc * focal
    depth = np.where(z > near, z, np.inf)
    return sx, sy, depth


def shade(normals, colours, view_dir):
    """Gouraud per-vertex shade: headlight diffuse + hemisphere ambient.

    `normals` (N,3) need not be unit (MC emits lerped normals); `colours`
    (N,3|4) in [0,1]."""
    n = _normalize(np.asarray(normals, np.float64))
    albedo = np.asarray(colours, np.float64)[:, :3]
    l = -np.asarray(view_dir, np.float64)
    # two-sided: the MC surface orientation depends on the isolevel sign
    diff = np.abs(n @ l)
    hemi = 0.5 + 0.5 * n[:, 1]
    c = albedo * (0.25 + 0.15 * hemi[:, None] + 0.7 * diff[:, None])
    return np.clip(c, 0.0, 1.0)


def _resolve_fragments(pix, z, rgb, width, height, img, zbuf):
    """Depth-resolve fragments (pix flat index, z, rgb) into img/zbuf."""
    if pix.size == 0:
        return
    order = np.lexsort((z, pix))
    pix, z, rgb = pix[order], z[order], rgb[order]
    first = np.ones(pix.shape[0], bool)
    first[1:] = pix[1:] != pix[:-1]
    pix, z, rgb = pix[first], z[first], rgb[first]
    win = z < zbuf.ravel()[pix]
    pix, z, rgb = pix[win], z[win], rgb[win]
    zbuf.ravel()[pix] = z
    img.reshape(-1, 3)[pix] = rgb


def render_mesh(vs, ns, cs, width=640, height=480, eye=None, center=None,
                up=(0.0, 1.0, 0.0), fov_deg=40.0, bg=(0.08, 0.09, 0.11),
                img=None, zbuf=None, batch=16384, max_block=64):
    """Rasterize a triangle soup (vs (3T,3), ns (3T,3), cs (3T,3|4)).

    Returns (img (H,W,3) float, zbuf (H,W)).  Pass img/zbuf to composite
    several soups (e.g. mesh + cloud) into one frame."""
    vs = np.asarray(vs, np.float64).reshape(-1, 3)
    T = vs.shape[0] // 3
    if img is None:
        img = np.empty((height, width, 3), np.float64)
        img[:] = np.asarray(bg, np.float64)
    if zbuf is None:
        zbuf = np.full((height, width), np.inf)
    if T == 0:
        return img, zbuf
    if center is None:
        center = 0.5 * (vs.min(0) + vs.max(0))
    if eye is None:
        eye = default_eye(vs, fov_deg)
    R, eye = look_at(eye, center, up)
    view = _normalize(np.asarray(center, np.float64) - eye)

    sx, sy, depth = project(vs, R, eye, fov_deg, width, height)
    col = shade(np.asarray(ns).reshape(-1, 3), np.asarray(cs).reshape(len(vs), -1), view)

    for t0 in range(0, T, batch):
        t1 = min(t0 + batch, T)
        sl = slice(3 * t0, 3 * t1)
        ax, ay, az = sx[sl][0::3], sy[sl][0::3], depth[sl][0::3]
        bx, by, bz = sx[sl][1::3], sy[sl][1::3], depth[sl][1::3]
        cx, cy, cz = sx[sl][2::3], sy[sl][2::3], depth[sl][2::3]
        ca, cb, cc = col[sl][0::3], col[sl][1::3], col[sl][2::3]
        ok = np.isfinite(az) & np.isfinite(bz) & np.isfinite(cz)
        x0 = np.maximum(np.floor(np.minimum(np.minimum(ax, bx), cx)), 0)
        x1 = np.minimum(np.ceil(np.maximum(np.maximum(ax, bx), cx)), width - 1)
        y0 = np.maximum(np.floor(np.minimum(np.minimum(ay, by), cy)), 0)
        y1 = np.minimum(np.ceil(np.maximum(np.maximum(ay, by), cy)), height - 1)
        ok &= (x1 >= x0) & (y1 >= y0)
        if not ok.any():
            continue

        def emit(idx, bx0, by0, P):
            """Rasterize a PxP candidate block at per-entry origin (bx0, by0)
            for the triangles `idx` (entries may repeat a triangle — the
            tiling path below subdivides oversized bboxes)."""
            px = (bx0[:, None, None] + np.arange(P)[None, :, None])
            py = (by0[:, None, None] + np.arange(P)[None, None, :])
            inb = (px <= x1[idx, None, None]) & (py <= y1[idx, None, None])
            pxc, pyc = px + 0.5, py + 0.5  # pixel centres
            # edge functions (signed areas)
            d = ((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))[idx, None, None]
            w0 = ((bx[idx, None, None] - pxc) * (cy[idx, None, None] - pyc)
                  - (by[idx, None, None] - pyc) * (cx[idx, None, None] - pxc))
            w1 = ((cx[idx, None, None] - pxc) * (ay[idx, None, None] - pyc)
                  - (cy[idx, None, None] - pyc) * (ax[idx, None, None] - pxc))
            w2 = d - w0 - w1
            dn = np.where(np.abs(d) < 1e-12, np.nan, d)
            b0, b1, b2 = w0 / dn, w1 / dn, w2 / dn
            inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & inb
            if not inside.any():
                return
            zf = (b0 * az[idx, None, None] + b1 * bz[idx, None, None]
                  + b2 * cz[idx, None, None])
            rgbf = (b0[..., None] * ca[idx, None, None, :]
                    + b1[..., None] * cb[idx, None, None, :]
                    + b2[..., None] * cc[idx, None, None, :])
            pixf = (py * width + px).astype(np.int64)
            m = inside.ravel()
            _resolve_fragments(pixf.ravel()[m], zf.ravel()[m],
                               rgbf.reshape(-1, 3)[m], width, height, img, zbuf)

        big = ok & ((x1 - x0 >= max_block) | (y1 - y0 >= max_block))
        small = ok & ~big
        if small.any():
            idx = np.nonzero(small)[0]
            P = int(max((x1 - x0)[idx].max(), (y1 - y0)[idx].max())) + 1
            emit(idx, x0[idx], y0[idx], P)
        if big.any():
            # close-up / grazing triangles: subdivide the bbox into
            # max_block-sized tiles so nothing is clipped (each tile is one
            # entry; x1/y1 bounds in `emit` trim the ragged edges)
            bidx = np.nonzero(big)[0]
            ntx = ((x1 - x0)[bidx] // max_block + 1).astype(np.int64)
            nty = ((y1 - y0)[bidx] // max_block + 1).astype(np.int64)
            ntiles = ntx * nty
            rep = np.repeat(np.arange(bidx.shape[0]), ntiles)
            tile = np.concatenate([np.arange(n) for n in ntiles])
            tx = tile % ntx[rep]
            ty = tile // ntx[rep]
            emit(bidx[rep], x0[bidx][rep] + tx * max_block,
                 y0[bidx][rep] + ty * max_block, max_block)
    return img, zbuf


def render_points(pos, colours, width=640, height=480, eye=None, center=None,
                  up=(0.0, 1.0, 0.0), fov_deg=40.0, bg=(0.08, 0.09, 0.11),
                  img=None, zbuf=None, radius=1):
    """Splat a point cloud ((N,3) positions, (N,3|4) colours) with a square
    `radius`-pixel splat and the same z-buffer as the mesh pass."""
    pos = np.asarray(pos, np.float64)
    if img is None:
        img = np.empty((height, width, 3), np.float64)
        img[:] = np.asarray(bg, np.float64)
    if zbuf is None:
        zbuf = np.full((height, width), np.inf)
    if pos.shape[0] == 0:
        return img, zbuf
    if center is None:
        center = 0.5 * (pos.min(0) + pos.max(0))
    if eye is None:
        eye = default_eye(pos, fov_deg)
    R, eye = look_at(eye, center, up)
    sx, sy, depth = project(pos, R, eye, fov_deg, width, height)
    col = np.clip(np.asarray(colours, np.float64)[:, :3], 0.0, 1.0)
    offs = np.arange(-(radius // 2), radius - radius // 2)
    for dx in offs:
        for dy in offs:
            px = np.round(sx + dx).astype(np.int64)
            py = np.round(sy + dy).astype(np.int64)
            m = ((px >= 0) & (px < width) & (py >= 0) & (py < height)
                 & np.isfinite(depth))
            _resolve_fragments((py[m] * width + px[m]), depth[m], col[m],
                               width, height, img, zbuf)
    return img, zbuf


def default_eye(verts, fov_deg=40.0, azimuth_deg=30.0, elevation_deg=20.0):
    """Frame the whole soup: orbit eye at a distance that fits the bbox."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    center = 0.5 * (verts.min(0) + verts.max(0))
    radius = float(np.linalg.norm(verts.max(0) - verts.min(0))) * 0.5
    return orbit_eye(center, radius, azimuth_deg, elevation_deg, fov_deg)


def orbit_eye(center, radius, azimuth_deg, elevation_deg=20.0, fov_deg=40.0):
    dist = max(radius, 1e-6) / np.tan(np.radians(fov_deg) * 0.5) * 1.15
    az, el = np.radians(azimuth_deg), np.radians(elevation_deg)
    d = np.array([np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
    return np.asarray(center, np.float64) + d * dist


def save_png(path, img) -> None:
    from PIL import Image

    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def render_frame(path, mesh=None, xs=None, width=640, height=480,
                 azimuth_deg=30.0, elevation_deg=20.0, fov_deg=40.0,
                 center=None, radius=None) -> None:
    """Render one exported frame (mesh and/or particle cloud) to a PNG.

    `center`/`radius` pin the camera across a sequence (turntable/animation);
    left None they are fitted to this frame's geometry."""
    geo = []
    if mesh is not None and len(mesh.vs):
        geo.append(np.asarray(mesh.vs, np.float64))
    if xs is not None and len(xs):
        geo.append(np.asarray(xs.position, np.float64))
    if not geo:
        raise ValueError("nothing to render")
    allv = np.concatenate(geo)
    if center is None:
        center = 0.5 * (allv.min(0) + allv.max(0))
    if radius is None:
        radius = float(np.linalg.norm(allv.max(0) - allv.min(0))) * 0.5
    eye = orbit_eye(center, radius, azimuth_deg, elevation_deg, fov_deg)
    img = zbuf = None
    if mesh is not None and len(mesh.vs):
        img, zbuf = render_mesh(mesh.vs, mesh.ns, mesh.cs, width, height,
                                eye=eye, center=center, fov_deg=fov_deg)
    if xs is not None and len(xs):
        img, zbuf = render_points(xs.position, xs.colour, width, height,
                                  eye=eye, center=center, fov_deg=fov_deg,
                                  img=img, zbuf=zbuf)
    save_png(path, img)


def load_obj_mesh(path):
    """Load a triangle-soup OBJ written by `export.save_obj_mesh` back into
    (vs (3T,3), ns (3T,3)) arrays — the turntable path for existing exports."""
    vs, ns = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                ns.append([float(x) for x in line.split()[1:4]])
    vs = np.asarray(vs, np.float64).reshape(-1, 3)
    ns = np.asarray(ns, np.float64).reshape(-1, 3) if ns else np.zeros_like(vs)
    return vs, ns
