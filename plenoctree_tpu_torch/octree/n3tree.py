"""Sparse N^3 tree (N=2 -> octree) with flat child-pointer arrays.

The port's own copy of plenoctree_tpu/octree/n3tree.py (host numpy, the
equivalent of svox.N3Tree): the same class, arrays and npz keys, so a
`tree.npz` written by either package loads in the other. Only the numpy
paths are kept: construction and point queries run as vectorized numpy,
with no native library behind them.

Storage layout (svox-compatible, npz keys as read by octree/compression.py:82-137
and the volrend viewer):
  data         [capacity, N, N, N, data_dim] float  leaf payload (SH/SG+sigma)
  child        [capacity, N, N, N] int32            relative child offset, 0=leaf
  parent_depth [capacity, 2] int32                  packed parent ptr, node depth
  invradius3   [3] float32                          world->tree scale (0.5/radius)
  offset       [3] float32                          world->tree shift
  depth_limit, geom_resize_fact, n_internal, n_free, data_format, extra_data

Tree coordinates: t = world * invradius + offset in [0, 1]^3; the root node's
N^3 cells are depth-0 leaves of side 1/N.
"""

import numpy as np


class DataFormat:
    """Leaf payload interpretation: RGBA | SH{basis} | SG{basis}."""

    RGBA = "RGBA"
    SH = "SH"
    SG = "SG"

    def __init__(self, txt=None):
        if txt is None or txt == "RGBA":
            self.format = self.RGBA
            self.basis_dim = 1
        elif txt.startswith("SH"):
            self.format = self.SH
            self.basis_dim = int(txt[2:])
            deg = int(round(self.basis_dim**0.5)) - 1
            if (deg + 1) ** 2 != self.basis_dim:
                raise ValueError(f"SH basis dim must be a square, got {self.basis_dim}")
            self.sh_deg = deg
        elif txt.startswith("SG"):
            self.format = self.SG
            self.basis_dim = int(txt[2:])
        else:
            raise ValueError(f"Unknown data format {txt}")

    def __repr__(self):
        if self.format == self.RGBA:
            return "RGBA"
        return f"{self.format}{self.basis_dim}"


class N3Tree:
    """Host-side sparse N^3 tree; see module docstring."""

    def __init__(
        self,
        N=2,
        data_dim=4,
        init_reserve=1,
        depth_limit=10,
        radius=0.5,
        center=(0.5, 0.5, 0.5),
        data_format=None,
        extra_data=None,
        geom_resize_fact=1.0,
        dtype=np.float32,
    ):
        if N < 2:
            raise ValueError(f"branch factor N must be >= 2, got {N}")
        # N is generic (svox parity: --tree_branch_n).
        self.N = N
        self.data_dim = data_dim
        self.depth_limit = depth_limit
        self.geom_resize_fact = geom_resize_fact
        self.dtype = dtype

        radius = np.broadcast_to(np.asarray(radius, np.float32), (3,)).copy()
        center = np.broadcast_to(np.asarray(center, np.float32), (3,)).copy()
        self.invradius = 0.5 / radius
        self.offset = 0.5 * (1.0 - center / radius)

        cap = max(init_reserve, 1)
        self.data = np.zeros((cap, N, N, N, data_dim), dtype=dtype)
        self.child = np.zeros((cap, N, N, N), dtype=np.int32)
        self.parent_depth = np.zeros((cap, 2), dtype=np.int32)
        self.parent_depth[0] = (-1, 0)
        self.n_internal = 1
        self.n_free = 0
        self.data_format = (
            data_format if isinstance(data_format, DataFormat) else DataFormat(data_format)
        )
        self.extra_data = (
            None if extra_data is None else np.asarray(extra_data, np.float32)
        )

    # -- basic properties ----------------------------------------------------
    @property
    def capacity(self):
        return self.data.shape[0]

    @property
    def n_leaves(self):
        return int((self.child[: self.n_internal] == 0).sum())

    def __repr__(self):
        return (
            f"N3Tree(N={self.N}, data_dim={self.data_dim}, "
            f"data_format={self.data_format}, n_internal={self.n_internal}, "
            f"n_leaves={self.n_leaves}, max_depth={self.max_depth})"
        )

    # -- coordinates -----------------------------------------------------------
    def world2tree(self, xyz):
        return np.asarray(xyz, np.float32) * self.invradius + self.offset

    def tree2world(self, t):
        return (np.asarray(t, np.float32) - self.offset) / self.invradius

    # -- leaf enumeration ------------------------------------------------------
    def _leaf_nodes(self):
        """[L, 4] (node, i, j, k) of all leaf cells, C-order (svox order)."""
        node, i, j, k = np.nonzero(self.child[: self.n_internal] == 0)
        return np.stack([node, i, j, k], axis=-1)

    @property
    def depths(self):
        """[n_leaves] depth of each leaf cell (node depth; root cells = 0)."""
        leaves = self._leaf_nodes()
        return self.parent_depth[leaves[:, 0], 1]

    @property
    def max_depth(self):
        return int(self.depths.max())

    def leaf_centers(self):
        """[n_leaves, 3] tree-coord centers of all leaf cells."""
        leaves = self._leaf_nodes()
        return self._cell_corner(leaves) + 0.5 * self._cell_size(leaves)[:, None]

    def _node_origins(self):
        """[n_internal, 3] tree-coord low corner of each *node* + its size.

        Derived by walking parent pointers root-ward (vectorized per level).
        """
        n = self.n_internal
        origins = np.zeros((n, 3), dtype=np.float64)
        sizes = np.ones((n,), dtype=np.float64)
        depth = self.parent_depth[:n, 1].astype(np.int64)
        # Reconstruct each node's path by following packed parent pointers.
        packed = self.parent_depth[:n, 0].astype(np.int64)
        cur = np.arange(n)
        # Iteratively add each ancestor cell's offset contribution.
        cell_scale = (1.0 / self.N) ** depth.astype(np.float64)
        sizes = cell_scale
        remaining = depth.copy()
        cur_packed = packed.copy()
        scale = cell_scale.copy()
        while (remaining > 0).any():
            act = remaining > 0
            pk = cur_packed[act]
            parent = pk // (self.N**3)
            cell = pk % (self.N**3)
            ci = cell // (self.N * self.N)
            cj = (cell // self.N) % self.N
            ck = cell % self.N
            contrib = np.stack([ci, cj, ck], -1).astype(np.float64)
            origins[act] += contrib * scale[act, None]
            cur_packed[act] = self.parent_depth[parent, 0].astype(np.int64)
            scale[act] *= self.N
            remaining[act] -= 1
        return origins, cell_scale

    def _cell_corner(self, leaves):
        """Tree-coord low corner of (node, i, j, k) cells: [L, 3]."""
        node_origin, node_scale = self._node_origins()
        org = node_origin[leaves[:, 0]]
        sz = node_scale[leaves[:, 0]] / self.N
        return (org + leaves[:, 1:].astype(np.float64) * sz[:, None]).astype(np.float32)

    def _cell_size(self, leaves):
        """Tree-coord side length of each leaf cell: [L]."""
        _, node_scale = self._node_origins()
        return (node_scale[leaves[:, 0]] / self.N).astype(np.float32)

    # -- queries ---------------------------------------------------------------
    def query_points(self, points, world=True):
        """Locate the leaf cell containing each point.

        Args:
          points: [P, 3] world (or tree if world=False) coordinates.

        Returns:
          (node [P], cell [P, 3], depth [P]): containing leaf cells. Points
          outside [0,1)^3 are clamped in.
        """
        t = self.world2tree(points) if world else np.asarray(points, np.float32)
        t = np.clip(t, 0.0, 1.0 - 1e-6).astype(np.float64)
        node = np.zeros(t.shape[0], dtype=np.int64)
        pos = t.copy()
        for _ in range(self.depth_limit + 1):
            idx = np.minimum((pos * self.N).astype(np.int64), self.N - 1)
            rel = self.child[node, idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.int64)
            live = rel != 0
            if not live.any():
                break
            node = np.where(live, node + rel, node)
            pos = np.where(live[:, None], pos * self.N - idx, pos)
        idx = np.minimum((pos * self.N).astype(np.int64), self.N - 1)
        return node, idx, self.parent_depth[node, 1]

    # -- refinement --------------------------------------------------------------
    def _ensure_capacity(self, needed):
        if needed <= self.capacity:
            return
        new_cap = max(needed, int(self.capacity * max(self.geom_resize_fact, 1.0)) + 1)
        grow = new_cap - self.capacity
        self.data = np.concatenate(
            [self.data, np.zeros((grow,) + self.data.shape[1:], self.data.dtype)], 0
        )
        self.child = np.concatenate(
            [self.child, np.zeros((grow,) + self.child.shape[1:], np.int32)], 0
        )
        self.parent_depth = np.concatenate(
            [self.parent_depth, np.zeros((grow, 2), np.int32)], 0
        )

    def refine_points(self, points, world=True):
        """Split every leaf cell containing one of `points` (one level).

        Cells already at depth_limit are left alone. Vectorized: dedups the
        (node, cell) targets, allocates all children in one batch.
        Equivalent to svox `tree[points].refine()` (octree/extraction.py:341-350).
        """
        node, cell, depth = self.query_points(points, world=world)
        ok = depth < self.depth_limit
        if not ok.any():
            return 0
        flat = (
            node[ok] * self.N**3
            + cell[ok, 0] * self.N**2
            + cell[ok, 1] * self.N
            + cell[ok, 2]
        )
        targets = np.unique(flat)
        n_new = targets.size
        start = self.n_internal
        self._ensure_capacity(start + n_new)
        new_ids = start + np.arange(n_new, dtype=np.int64)
        tnode = targets // self.N**3
        tcell = targets % self.N**3
        ti = tcell // (self.N * self.N)
        tj = (tcell // self.N) % self.N
        tk = tcell % self.N
        self.child[tnode, ti, tj, tk] = (new_ids - tnode).astype(np.int32)
        self.parent_depth[new_ids, 0] = targets.astype(np.int32)
        self.parent_depth[new_ids, 1] = self.parent_depth[tnode, 1] + 1
        # Children inherit the parent cell's data (svox refine semantics).
        self.data[new_ids] = self.data[tnode, ti, tj, tk][:, None, None, None, :]
        self.n_internal += n_new
        return n_new

    def build_from_points(self, points, depth=None, world=True):
        """Build the full tree structure from occupied points: `depth`
        rounds of refine_points (octree/extraction.py:341-350). Only valid
        on a fresh tree."""
        depth = self.depth_limit if depth is None else depth
        if self.n_internal != 1:
            raise ValueError("build_from_points requires a fresh tree")
        for _ in range(depth):
            self.refine_points(points, world=world)
        return self

    # -- leaf data access --------------------------------------------------------
    def leaf_sample_points(self, leaf_ind, samples_per_cell, rng=None):
        """[#ind, S, 3] world-coord uniform samples inside selected leaves
        (parity: svox sample(), used by octree/extraction.py:369)."""
        rng = rng or np.random.default_rng()
        leaves = self._leaf_nodes()[leaf_ind]
        corner = self._cell_corner(leaves)
        size = self._cell_size(leaves)
        u = rng.random((leaves.shape[0], samples_per_cell, 3), dtype=np.float64)
        t = corner[:, None, :] + u * size[:, None, None]
        return self.tree2world(t.astype(np.float32))

    def get_leaf_data(self, leaf_ind=None):
        leaves = self._leaf_nodes() if leaf_ind is None else self._leaf_nodes()[leaf_ind]
        return self.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]]

    def set_leaf_data(self, leaf_ind, values):
        leaves = self._leaf_nodes()[leaf_ind]
        self.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]] = values

    def relu_sigma_(self):
        """In-place relu of the sigma channel (octree/extraction.py:503)."""
        np.maximum(self.data[..., -1], 0.0, out=self.data[..., -1])

    def shrink_to_fit(self):
        self.data = self.data[: self.n_internal]
        self.child = self.child[: self.n_internal]
        self.parent_depth = self.parent_depth[: self.n_internal]

    def clone(self):
        import copy

        t = N3Tree.__new__(N3Tree)
        t.__dict__ = {
            k: (v.copy() if isinstance(v, np.ndarray) else copy.copy(v))
            for k, v in self.__dict__.items()
        }
        return t

    # -- serialization -------------------------------------------------------------
    def save(self, pth, compress=True, data_dtype=np.float16):
        """Write svox-layout npz (data stored half like svox's save)."""
        payload = {
            "data_dim": self.data_dim,
            "child": self.child[: self.n_internal],
            "parent_depth": self.parent_depth[: self.n_internal],
            "n_internal": self.n_internal,
            "n_free": self.n_free,
            "invradius3": self.invradius.astype(np.float32),
            "offset": self.offset.astype(np.float32),
            "depth_limit": self.depth_limit,
            "geom_resize_fact": self.geom_resize_fact,
            "data": self.data[: self.n_internal].astype(data_dtype),
        }
        if self.data_format is not None:
            payload["data_format"] = repr(self.data_format)
        if self.extra_data is not None:
            payload["extra_data"] = self.extra_data
        save = np.savez_compressed if compress else np.savez
        save(pth, **payload)

    @classmethod
    def load(cls, pth, dtype=np.float32):
        z = np.load(pth, allow_pickle=False)
        t = cls.__new__(cls)
        t.N = int(z["child"].shape[1])
        t.data_dim = int(z["data_dim"])
        t.child = z["child"].astype(np.int32)
        t.parent_depth = z["parent_depth"].astype(np.int32)
        t.n_internal = int(z["n_internal"])
        t.n_free = int(z["n_free"]) if "n_free" in z.files else 0
        if "invradius3" in z.files:
            t.invradius = z["invradius3"].astype(np.float32)
        else:
            t.invradius = np.broadcast_to(
                np.asarray(z["invradius"], np.float32), (3,)
            ).copy()
        t.offset = z["offset"].astype(np.float32)
        t.depth_limit = int(z["depth_limit"]) if "depth_limit" in z.files else 10
        t.geom_resize_fact = (
            float(z["geom_resize_fact"]) if "geom_resize_fact" in z.files else 1.0
        )
        t.data = z["data"].astype(dtype)
        t.dtype = dtype
        t.data_format = DataFormat(
            str(z["data_format"]) if "data_format" in z.files else None
        )
        t.extra_data = z["extra_data"].astype(np.float32) if "extra_data" in z.files else None
        return t
