"""Isosurface extraction by marching tetrahedra, in torch on the volume's
device, and the OBJ writer.

Port of plenoctree_tpu/ops/marching.py: `marching_tetrahedra` returns the
same vertices and triangles as the JAX package's numpy function, bit for
bit and in the same order. Each grid cube splits into six tetrahedra around
its 0-7 diagonal; each tetrahedron gives 0-2 triangles whose vertices are
interpolated onto the isosurface; vertices whose coordinates round to the
same 1e-6 grid are welded, and triangles that collapse are dropped.

The numpy function gathers an [C, 8, 3] corner index for all C cells (at
300^3 that index alone is ~5.2 GB); here the inside/outside test of the
eight corners is taken on shifted slices of the volume, and only the cells
the surface crosses are gathered. The order is the numpy one: cells in C
order, then the six tetrahedra, the sign patterns in `_TET_TRIS`'s order,
the pattern's triangles, and the cells. Each arithmetic step is one eager
op in float64, as numpy does it (no fused multiply-add); the weld sorts the
rounded coordinates with three stable sorts, which gives np.unique's
lexicographic order and its first occurrence of each vertex.
"""

import numpy as np
import torch

# Kuhn subdivision: six tetrahedra around the 0-7 main diagonal, each a
# one-bit-at-a-time path 0 -> 7; corner i sits at (i & 1, i >> 1 & 1, i >> 2 & 1).
_CUBE_TETS = ((0, 1, 3, 7), (0, 1, 7, 5), (0, 5, 7, 4), (0, 4, 7, 6), (0, 6, 7, 2),
              (0, 2, 7, 3))
_CORNER_OFFSETS = tuple(((i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8))
# Tet edges 0:(0,1) 1:(0,2) 2:(0,3) 3:(1,2) 4:(1,3) 5:(2,3); per inside
# pattern of the four corners, its triangles as triples of edge ids.
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_TET_TRIS = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 4, 3)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 5, 4)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1001: [(0, 1, 5), (0, 5, 4)],
    0b0110: [(0, 4, 5), (0, 5, 1)],
    0b1010: [(0, 2, 5), (0, 5, 3)],
    0b1100: [(1, 4, 2), (1, 3, 4)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 5, 3)],
    0b1101: [(0, 3, 4)],
    0b1110: [(0, 2, 1)],
}


def _active_cells(volume, iso):
    """Linear C-order indices of the cells with corners on both sides."""
    nx, ny, nz = volume.shape
    inside = volume > iso
    any_in = all_in = None
    for dx, dy, dz in _CORNER_OFFSETS:
        c = inside[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        any_in = c.clone() if any_in is None else any_in.logical_or_(c)
        all_in = c.clone() if all_in is None else all_in.logical_and_(c)
    return torch.nonzero((any_in & ~all_in).reshape(-1)).reshape(-1)


def _weld(verts):
    """(first occurrence of each distinct rounded vertex in lexicographic
    order, index of each vertex's distinct row): np.unique(axis=0,
    return_index=True, return_inverse=True) of round(verts * 1e6)."""
    keys = torch.round(verts * 1e6).long()
    perm = torch.arange(keys.shape[0], device=keys.device)
    for col in (2, 1, 0):  # least significant column first, each sort stable
        order = torch.sort(keys[perm, col], stable=True).indices
        perm = perm[order]
    ks = keys[perm]
    new = torch.ones(ks.shape[0], dtype=torch.bool, device=ks.device)
    new[1:] = (ks[1:] != ks[:-1]).any(dim=1)
    group = torch.cumsum(new.long(), 0) - 1
    inverse = torch.empty_like(group)
    inverse[perm] = group
    return perm[new], inverse


def marching_tetrahedra(volume, iso):
    """Extract the isosurface of a dense scalar volume.

    Args:
      volume: [X, Y, Z] float tensor (or numpy array) of scalar samples.
      iso: isolevel.

    Returns:
      vertices: [V, 3] float64 positions in index coordinates, and
      triangles: [T, 3] int64 vertex indices, on the volume's device.
    """
    volume = torch.as_tensor(volume).double()
    dev = volume.device
    nx, ny, nz = volume.shape
    iso = float(iso)
    cells = _active_cells(volume, iso)
    if cells.numel() == 0:
        return (torch.zeros((0, 3), dtype=torch.float64, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    cz = cells % (nz - 1)
    cy = (cells // (nz - 1)) % (ny - 1)
    cx = cells // ((nz - 1) * (ny - 1))
    corner = [torch.stack([cx + dx, cy + dy, cz + dz], dim=-1) for dx, dy, dz in _CORNER_OFFSETS]
    vals = [volume[c[:, 0], c[:, 1], c[:, 2]] for c in corner]  # 8 x [A]
    inside = [v > iso for v in vals]
    pos = [c.double() for c in corner]

    all_verts = []
    for tet in _CUBE_TETS:
        code = (inside[tet[0]].long() | (inside[tet[1]].long() << 1)
                | (inside[tet[2]].long() << 2) | (inside[tet[3]].long() << 3))
        for pattern, tris in _TET_TRIS.items():
            sel = torch.nonzero(code == pattern).reshape(-1)
            if sel.numel() == 0:
                continue
            for tri in tris:
                tri_verts = []
                for e in tri:
                    a, b = (tet[i] for i in _TET_EDGES[e])
                    va, vb = vals[a][sel], vals[b][sel]
                    diff = vb - va
                    den = torch.where(diff.abs() < 1e-12, torch.full_like(diff, 1e-12), diff)
                    t = (iso - va) / den
                    t = torch.clamp(t, 0.0, 1.0)
                    pa, pb = pos[a][sel], pos[b][sel]
                    tri_verts.append(pa + t[:, None] * (pb - pa))
                all_verts.append(torch.stack(tri_verts, dim=1).reshape(-1, 3))
    verts = torch.cat(all_verts, dim=0)
    tris = torch.arange(verts.shape[0], device=dev).reshape(-1, 3)
    first, inverse = _weld(verts)
    verts = verts[first]
    tris = inverse[tris]
    ok = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    return verts, tris[ok]


def _cat_columns(prefix, cols):
    """Lines `prefix c0 c1 c2` of string columns, joined by numpy."""
    line = np.char.add(prefix, cols[:, 0])
    for k in (1, 2):
        line = np.char.add(np.char.add(line, " "), cols[:, k])
    return line


def save_obj(vertices, triangles, pth):
    """Write a wavefront OBJ, the same bytes as the JAX package's save_obj
    (each coordinate as numpy prints a float64, the shortest repr; faces
    1-based); the lines are built by numpy, not one Python step each."""
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    parts = []
    if len(verts):
        parts.append("\n".join(_cat_columns("v ", verts.astype(str)).tolist()) + "\n")
    if len(tris):
        parts.append("\n".join(_cat_columns("f ", (tris + 1).astype(str)).tolist()) + "\n")
    with open(pth, "w") as f:
        f.write("".join(parts))
