"""Linear (Morton-keyed) octree: the replacement for DynOctTree.

Behavioral equivalent of the reference pointer octree
(include/hpmvs/doctree.h:122-523): `at()` point lookup, `add(e, width)` with
split-to-width, `addConditional` (add only if the target leaf is empty and
not finer -- the cornerstone of collision-free expansion, doctree.h:396-419),
`remove` with branch collapapse, node levels, histograms and subtree views.

Design (SURVEY.md section 7): cells are (level, morton-key) pairs in flat
numpy arrays -- no pointers. The *structure* of the reference tree (which
empty leaves exist where) is derived from the occupied cells: a branch at
level L containing point p exists iff some occupied cell at level > L shares
p's level-L ancestor key. This equals the reference tree with empty branches
fully collapsed (the reference collapses them lazily one level per remove,
doctree.h:421-433; divergence documented). All queries are vectorized
(sorted-key membership via np.searchsorted per level), so scheduling cost is
O(batch x levels x log cells) instead of per-patch pointer chasing.

The large queries (structure_level, containing_cell, lookup, and key_at
over 4096 points or more at one level) go to the native query library
(core/native.py, native/octree_core.cpp built at first use) unless the tree
is made with native=False; the numpy path is its twin and answers
bit-identically (tests/test_torch_native.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from hpmvs_tpu_torch.core import native as native_lib

MAX_LEVELS = 21  # 3*21 = 63 morton bits


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of v so they occupy every 3rd bit (uint64)."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_encode(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray) -> np.ndarray:
    return (_spread_bits(ix) | (_spread_bits(iy) << np.uint64(1))
            | (_spread_bits(iz) << np.uint64(2)))


def morton_ancestor(keys: np.ndarray, from_level, to_level) -> np.ndarray:
    """Ancestor key: drop 3 bits per level."""
    shift = (np.asarray(from_level, dtype=np.uint64)
             - np.asarray(to_level, dtype=np.uint64)) * np.uint64(3)
    return keys >> shift


class PatchStore:
    """Growable structure-of-arrays patch table (Patch3d fields,
    include/hpmvs/Patch3d.h:33-83)."""

    FIELDS = ("center", "normal", "scale", "views", "color", "flatness",
              "expanded", "prio_red", "alive", "cell", "dirty", "nxt")

    def __init__(self, max_views: int, cap: int = 1024):
        self.K = max_views
        self._cap = cap
        self.n = 0
        self.center = np.zeros((cap, 3), np.float32)
        self.normal = np.zeros((cap, 3), np.float32)
        self.scale = np.zeros((cap,), np.float32)
        self.views = np.full((cap, max_views), -1, np.int32)
        self.color = np.zeros((cap, 3), np.float32)
        self.flatness = np.full((cap,), -1.0, np.float32)
        self.expanded = np.zeros((cap,), bool)
        self.prio_red = np.zeros((cap,), np.int32)
        self.alive = np.zeros((cap,), bool)
        self.cell = np.full((cap,), -1, np.int64)
        # Patch3d::dirty_ (Patch3d.h:68): set on border arrivals so resume
        # re-queues them even when already expanded (CellProcessor.cpp:443)
        self.dirty = np.zeros((cap,), bool)
        # intrusive next-in-cell chain (the Leaf::data vector of doctree.h
        # as flat arrays): cell_head[cid] -> pid -> nxt[pid] -> ... -> -1
        self.nxt = np.full((cap,), -1, np.int64)

    def _grow(self, need: int):
        while self._cap < need:
            self._cap *= 2
        for f in ("center", "normal", "views", "color"):
            a = getattr(self, f)
            b = np.zeros((self._cap,) + a.shape[1:], a.dtype)
            if f == "views":
                b.fill(-1)
            b[:a.shape[0]] = a
            setattr(self, f, b)
        for f, fill in (("scale", 0), ("flatness", -1.0), ("expanded", False),
                        ("prio_red", 0), ("alive", False), ("cell", -1),
                        ("dirty", False), ("nxt", -1)):
            a = getattr(self, f)
            b = np.full((self._cap,), fill, a.dtype)
            b[:a.shape[0]] = a
            setattr(self, f, b)

    def alloc(self, n: int) -> np.ndarray:
        if self.n + n > self._cap:
            self._grow(self.n + n)
        ids = np.arange(self.n, self.n + n, dtype=np.int64)
        self.n += n
        self.alive[ids] = True
        self.flatness[ids] = -1.0
        self.expanded[ids] = False
        self.prio_red[ids] = 0
        self.cell[ids] = -1
        self.dirty[ids] = False
        self.nxt[ids] = -1
        return ids

    def free(self, ids: np.ndarray):
        self.alive[ids] = False
        self.cell[ids] = -1
        self.views[ids] = -1
        self.nxt[ids] = -1


class LinearOctree:
    """Occupied-cell table + derived structure queries. native: answer the
    large queries with the native library (core/native.py), else numpy."""

    def __init__(self, center: np.ndarray, width: float,
                 max_level: int = MAX_LEVELS - 1, native: bool = True):
        self.center = np.asarray(center, np.float64)
        self.width = float(width)
        self.max_level = max_level
        self.native = native
        cap = 1024
        self._cap = cap
        self.n = 0
        self.level = np.zeros((cap,), np.int8)
        self.key = np.zeros((cap,), np.uint64)
        self.alive = np.zeros((cap,), bool)
        self._index: Optional[Dict] = None  # lazy per-level sorted indexes

    # -- storage ---------------------------------------------------------
    def _grow(self, need: int):
        while self._cap < need:
            self._cap *= 2
        for f, fill in (("level", 0), ("key", 0), ("alive", False)):
            a = getattr(self, f)
            b = np.full((self._cap,), fill, a.dtype)
            b[:a.shape[0]] = a
            setattr(self, f, b)

    def alloc_cells(self, levels: np.ndarray, keys: np.ndarray) -> np.ndarray:
        n = len(levels)
        if self.n + n > self._cap:
            self._grow(self.n + n)
        ids = np.arange(self.n, self.n + n, dtype=np.int64)
        self.level[ids] = levels
        self.key[ids] = keys
        self.alive[ids] = True
        self.n += n
        self._index = None
        return ids

    def free_cells(self, ids: np.ndarray):
        self.alive[ids] = False
        self._index = None

    # -- geometry --------------------------------------------------------
    def cell_coords(self, pts: np.ndarray, level) -> np.ndarray:
        """Integer cell coordinates of points at `level` (root = level 0 is
        one cell of width `self.width`)."""
        level = np.asarray(level)
        res = (2 ** level.astype(np.int64))
        cw = self.width / res
        lo = self.center - self.width / 2.0
        ij = np.floor((pts - lo) / cw[..., None]).astype(np.int64)
        return np.clip(ij, 0, (res - 1)[..., None])

    def key_at(self, pts: np.ndarray, level) -> np.ndarray:
        lv = np.asarray(level)
        if self.native and lv.ndim == 0 \
                and pts.shape[0] >= native_lib.SORT_THRESHOLD:
            return native_lib.keys_at_level(pts, self.center, self.width,
                                            int(lv))
        ij = self.cell_coords(pts, np.broadcast_to(level, (pts.shape[0],)))
        return morton_encode(ij[:, 0], ij[:, 1], ij[:, 2])

    def keys_at_levels(self, pts: np.ndarray, lv: np.ndarray) -> np.ndarray:
        """Keys of points each at its own level (one key_at per level)."""
        keys = np.zeros(len(pts), np.uint64)
        for L in np.unique(lv):
            m = lv == L
            keys[m] = self.key_at(pts[m], int(L))
        return keys

    def seed_pushdown(self, pts: np.ndarray, lv: np.ndarray):
        """Seed conflict push-down (doctree.h:378-394 split-with-buffer
        semantics): finer structure made by co-located finer seeds pushes
        coarser seeds down until no seed's cell holds another seed's finer
        cell. Returns (levels, keys at those levels)."""
        if self.native:
            return native_lib.seed_pushdown(np.asarray(pts, np.float64),
                                            self.center, self.width,
                                            self.max_level, lv)
        lv = np.asarray(lv, np.int64)
        for _ in range(self.max_level):
            tmp = LinearOctree(self.center, self.width, self.max_level,
                               native=False)
            tmp.alloc_cells(lv.astype(np.int8), self.keys_at_levels(pts, lv))
            new_lv = np.maximum(lv, tmp.structure_level(pts))
            if (new_lv == lv).all():
                break
            lv = new_lv
        return lv, self.keys_at_levels(pts, lv)

    def contains(self, pts: np.ndarray) -> np.ndarray:
        lo = self.center - self.width / 2.0
        hi = self.center + self.width / 2.0
        # Branch::contains uses strict/closed bounds via sign tests; half-open
        # [lo, hi) matches the coordinate clipping used for keys
        return np.all((pts >= lo) & (pts < hi), axis=1)

    def cell_center_width(self, cid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        lv = self.level[cid].astype(np.int64)
        key = self.key[cid]
        ix = _compact_bits(key)
        iy = _compact_bits(key >> np.uint64(1))
        iz = _compact_bits(key >> np.uint64(2))
        cw = self.width / (2 ** lv)
        lo = self.center - self.width / 2.0
        c = np.stack([ix, iy, iz], axis=-1).astype(np.float64)
        return lo + (c + 0.5) * cw[:, None], cw

    # -- derived structure ----------------------------------------------
    def _build_index(self):
        occ = {}
        alive = np.nonzero(self.alive[:self.n])[0]
        lvls = self.level[alive]
        keys = self.key[alive]
        for lv in range(self.max_level + 1):
            m = lvls == lv
            if m.any():
                k = keys[m]
                order = np.argsort(k)
                occ[lv] = (k[order], alive[m][order])
        anc = {}
        for lv in range(self.max_level + 1):
            parts = []
            for l2, (k2, _) in occ.items():
                if l2 > lv:
                    parts.append(morton_ancestor(k2, l2, lv))
            anc[lv] = (np.unique(np.concatenate(parts)) if parts
                       else np.zeros((0,), np.uint64))
        self._index = {"occ": occ, "anc": anc}
        if self.native:
            self._index.update(self._flat_index(occ, anc))

    def _flat_index(self, occ, anc):
        """The per-level sets flattened for the native library: sorted keys
        of every level back to back, with level offsets (and cell ids)."""
        nl = self.max_level + 1
        anc_off = np.zeros(nl + 1, np.int64)
        occ_off = np.zeros(nl + 1, np.int64)
        anc_parts, occ_parts, cid_parts = [], [], []
        for lv in range(nl):
            anc_off[lv + 1] = anc_off[lv] + len(anc[lv])
            anc_parts.append(anc[lv])
            k, cids = occ.get(lv, (np.zeros((0,), np.uint64),
                                   np.zeros((0,), np.int64)))
            occ_off[lv + 1] = occ_off[lv] + len(k)
            occ_parts.append(k)
            cid_parts.append(cids.astype(np.int64))
        return {"anc_flat": np.concatenate(anc_parts).astype(np.uint64),
                "anc_off": anc_off,
                "occ_flat": np.concatenate(occ_parts).astype(np.uint64),
                "occ_off": occ_off,
                "occ_cid": np.concatenate(cid_parts).astype(np.int64)}

    def _idx(self):
        if self._index is None:
            self._build_index()
        return self._index

    @staticmethod
    def _member(sorted_keys: np.ndarray, q: np.ndarray) -> np.ndarray:
        if len(sorted_keys) == 0:
            return np.zeros(q.shape, bool)
        pos = np.searchsorted(sorted_keys, q)
        pos_c = np.minimum(pos, len(sorted_keys) - 1)
        return sorted_keys[pos_c] == q

    def structure_level(self, pts: np.ndarray) -> np.ndarray:
        """Level of the leaf `at(p)` would return: 1 + deepest branch level
        containing p (0 when the tree is empty at p)."""
        idx = self._idx()
        if self.native:
            return native_lib.structure_level(
                self.key_at(pts, self.max_level), self.max_level,
                idx["anc_flat"], idx["anc_off"])
        out = np.zeros((pts.shape[0],), np.int64)
        for lv in range(self.max_level + 1):
            anc = idx["anc"][lv]
            if len(anc) == 0:
                continue
            q = self.key_at(pts, lv)
            out = np.where(self._member(anc, q), lv + 1, out)
        return out

    def containing_cell(self, pts: np.ndarray) -> np.ndarray:
        """Occupied cell id containing each point, or -1 (leaves are
        disjoint, so at most one level matches)."""
        idx = self._idx()
        if self.native:
            return native_lib.containing_cell(
                self.key_at(pts, self.max_level), self.max_level,
                idx["occ_flat"], idx["occ_off"], idx["occ_cid"])
        out = np.full((pts.shape[0],), -1, np.int64)
        for lv, (keys, cids) in idx["occ"].items():
            q = self.key_at(pts, lv)
            pos = np.searchsorted(keys, q)
            pos_c = np.minimum(pos, len(keys) - 1)
            hit = (keys[pos_c] == q) & (out < 0)
            out = np.where(hit, cids[pos_c], out)
        return out

    def lookup(self, levels: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Cell ids for exact (level, key) pairs, -1 if absent."""
        idx = self._idx()
        if self.native:
            return native_lib.lookup_cells(levels, keys, self.max_level,
                                           idx["occ_flat"], idx["occ_off"],
                                           idx["occ_cid"])
        out = np.full(keys.shape, -1, np.int64)
        for lv, (k, cids) in idx["occ"].items():
            m = levels == lv
            if not m.any():
                continue
            pos = np.searchsorted(k, keys[m])
            pos_c = np.minimum(pos, len(k) - 1)
            hit = k[pos_c] == keys[m]
            res = np.where(hit, cids[pos_c], -1)
            out[m] = res
        return out

    def reroot(self, direction: np.ndarray) -> None:
        """Grow the root cube by one level: the old root becomes one octant
        of a doubled root (cheap for a linear octree -- every key gains the
        octant bits at its top, doctree has no equivalent; reference
        behavior was to DROP outside-root patches, CellProcessor.cpp:147).

        direction[axis] >= 0 grows toward +axis (old root sits in the low
        octant there), < 0 toward -axis (old root in the high octant).
        Cell ids are stable; every cell's level increases by exactly 1, so
        callers must shift any level-derived priorities by +10."""
        d = np.where(np.asarray(direction, np.float64) >= 0, 1.0, -1.0)
        ob = (d < 0).astype(np.uint64)          # 1 = old root in high half
        okey = morton_encode(ob[0:1], ob[1:2], ob[2:3])[0]
        lv = self.level[:self.n].astype(np.uint64)
        self.key[:self.n] |= okey << (np.uint64(3) * lv)
        self.level[:self.n] += 1
        assert int(self.level[:self.n].max(initial=0)) <= MAX_LEVELS - 1, \
            "reroot would exceed the morton bit budget"
        self.center = self.center + d * self.width / 2.0
        self.width *= 2.0
        self.max_level = min(self.max_level + 1, MAX_LEVELS - 1)
        self._index = None

    def level_for_width(self, widths: np.ndarray) -> np.ndarray:
        """Level reached by add(e, width): split while leaf_width/2 > width
        (doctree.h:383) => smallest L with rootW/2^(L+1) <= width."""
        w = np.maximum(np.asarray(widths, np.float64), 1e-30)
        L = np.ceil(np.log2(self.width / w) - 1.0 - 1e-9).astype(np.int64)
        return np.clip(L, 0, self.max_level)

    def node_level(self, cid: np.ndarray) -> np.ndarray:
        return self.level[cid].astype(np.int64)

    def histogram(self) -> np.ndarray:
        """Per-level occupied-cell histogram (doctree.h:493-511)."""
        alive = np.nonzero(self.alive[:self.n])[0]
        if len(alive) == 0:
            return np.zeros((1,), np.int64)
        lv = self.level[alive].astype(np.int64)
        return np.bincount(lv)


def _compact_bits(v: np.ndarray) -> np.ndarray:
    """Inverse of _spread_bits: gather every 3rd bit into the low 21 bits."""
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v
