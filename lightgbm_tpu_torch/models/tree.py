"""Decision tree model as a small dataclass of tensors.

Counterpart of lightgbm_tpu/models/tree.py.  The layout is the
reference's flat-array Tree (tree.h:18-198): internal nodes
``0..L-2``, leaves addressed as ``~leaf`` in child pointers, every
per-node and per-leaf field padded to the ``max_leaves`` training
budget.  ``num_leaves`` is the used leaf count, kept as a Python int
(the port reads it on the host anyway: growth syncs once per split).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

_INT_FIELDS = ("split_feature", "split_feature_real", "threshold_bin",
               "decision_type", "left_child", "right_child", "leaf_parent",
               "leaf_depth")
_NODE_FIELDS = ("split_feature", "split_feature_real", "threshold_bin",
                "threshold_real", "decision_type", "left_child",
                "right_child", "split_gain", "internal_value",
                "internal_count")
_LEAF_FIELDS = ("leaf_value", "leaf_count", "leaf_parent", "leaf_depth")
TREE_FIELDS = _NODE_FIELDS + _LEAF_FIELDS


@dataclasses.dataclass
class Tree:
    num_leaves: int  # used leaves (1 = stump)
    # internal nodes [max_leaves-1]
    split_feature: torch.Tensor  # inner feature index
    split_feature_real: torch.Tensor  # original column index (model IO)
    threshold_bin: torch.Tensor  # bin-space threshold
    threshold_real: torch.Tensor  # raw-value threshold (filled at finalize)
    decision_type: torch.Tensor  # 0 numerical (<=), 1 categorical (==)
    left_child: torch.Tensor  # node idx or ~leaf
    right_child: torch.Tensor
    split_gain: torch.Tensor
    internal_value: torch.Tensor
    internal_count: torch.Tensor
    # leaves [max_leaves]
    leaf_value: torch.Tensor
    leaf_count: torch.Tensor
    leaf_parent: torch.Tensor
    leaf_depth: torch.Tensor

    @property
    def max_leaves(self) -> int:
        return self.leaf_value.shape[-1]

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)

    def shrink(self, rate: float) -> "Tree":
        """Tree::Shrinkage (tree.h:103-107)."""
        return self.replace(leaf_value=self.leaf_value * rate,
                            internal_value=self.internal_value * rate)


def empty_tree(max_leaves: int, device="cpu") -> Tree:
    li = max_leaves - 1

    def full(n, v, dt):
        return torch.full((n,), v, dtype=dt, device=device)

    i32, f32 = torch.int32, torch.float32
    return Tree(
        num_leaves=1,
        split_feature=full(li, -1, i32),
        split_feature_real=full(li, -1, i32),
        threshold_bin=full(li, 0, i32),
        threshold_real=full(li, 0, f32),
        decision_type=full(li, 0, i32),
        left_child=full(li, 0, i32),
        right_child=full(li, 0, i32),
        split_gain=full(li, 0, f32),
        internal_value=full(li, 0, f32),
        internal_count=full(li, 0, f32),
        leaf_value=full(max_leaves, 0, f32),
        leaf_count=full(max_leaves, 0, f32),
        leaf_parent=full(max_leaves, -1, i32),
        leaf_depth=full(max_leaves, 0, i32),
    )


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
CAT_BIT = 1 << 31  # a categorical node's flag in P1's record


def f32_to_i32_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts (the JAX walk's
    ``astype(jnp.int32)``): NaN -> 0, values >= 2**31 -> 2**31-1, values
    < -2**31 -> -2**31, everything else truncated toward zero.  Torch's
    own cast wraps NaN and every out-of-range value to -2**31 on the
    CPU.  Every float32 is exact in float64, so the clamp there is
    exact."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def _walk(tree: Tree, X_bin: torch.Tensor) -> torch.Tensor:
    """Lockstep root-to-leaf walk of every row of a BINNED matrix
    (Tree::GetLeaf, tree.cpp:98-122): numerical splits go left when
    ``bin <= threshold_bin``, categorical ones when ``bin ==
    threshold_bin``.  Rows that reached a leaf keep their (negative)
    node; the loop ends when none is left or after max_leaves-1 steps.
    Returns the leaf index per row."""
    n = X_bin.shape[0]
    start = 0 if tree.num_leaves > 1 else -1
    node = torch.full((n,), start, dtype=torch.int64, device=X_bin.device)
    if tree.num_leaves <= 1:
        return ~node
    is_cat_n = tree.decision_type.to(torch.int64) == 1
    lch = tree.left_child.to(torch.int64)
    rch = tree.right_child.to(torch.int64)
    feat = tree.split_feature.to(torch.int64).clamp(min=0)
    thr = tree.threshold_bin
    for _ in range(tree.max_leaves - 1):
        active = node >= 0
        if not bool(active.any()):
            break
        idx = node.clamp(min=0)
        t = thr[idx]
        v = X_bin.gather(1, feat[idx][:, None])[:, 0]
        go_left = torch.where(is_cat_n[idx], v == t, v <= t)
        nxt = torch.where(go_left, lch[idx], rch[idx])
        node = torch.where(active, nxt, node)
    return ~node


def predict_leaf_binned(tree: Tree, X_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index per row of a BINNED row-major matrix ``[n, F]``."""
    return _walk(tree, X_bin.to(torch.int32))


def predict_binned(tree: Tree, X_bin: torch.Tensor) -> torch.Tensor:
    """One tree's output per row of a BINNED row-major matrix ``[n, F]``:
    the reference walk (the JAX package's ``predict_binned``), one host
    sync a level.  Training walks its trees with kernel P2 and its plain
    version (``binned_update_`` / ``binned_replay_`` below)."""
    return tree.leaf_value[predict_leaf_binned(tree, X_bin)]


# ------------------------------------------------------- binned ensembles
@dataclasses.dataclass
class BinnedTrees:
    """Trees as one flat node table in BIN space, the table kernel P2
    (csrc/predict_binned.cu) walks: the used internal nodes of every tree
    one after the other, each one 16-byte record ``{split_feature |
    categorical << 31, threshold_bin, left_child, right_child}``, with
    global child pointers (an internal child is its row, a leaf ``~j``
    with ``j`` its row in ``leaf_value``).  ``root[t]`` is tree t's first
    record (``~leaf_offset[t]`` for a one-leaf tree): a host list for the
    plain walk, and ``root_dev`` the same on the table's device for P2,
    beside each tree's first record and first leaf (``node_offset``,
    ``leaf_offset``, ``[T + 1]``).  The offsets are host ints: every
    tree's ``num_leaves`` is one, so ``binned_table`` builds the table on
    the trees' device with no read back."""

    node: torch.Tensor  # [nodes, 4] int32 records
    leaf_value: torch.Tensor  # [leaves] f32
    root: List[int]  # [T] host
    max_steps: int  # the most internal nodes of one tree: a walk's bound
    root_dev: torch.Tensor  # [T] int32, ``root`` on the device
    node_offset: torch.Tensor  # [T + 1] int32, tree t's first record
    leaf_offset: torch.Tensor  # [T + 1] int32, tree t's first leaf

    @property
    def num_trees(self) -> int:
        return len(self.root)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``.  To a card through pinned memory and a
    copy that does not block the host (a pageable copy waits for the
    stream: a sync on every call)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# the int fields of a node record, in one torch.cat: feature, threshold,
# left, right, then the decision type that sets the feature's top bit
_RECORD_FIELDS = ("split_feature", "threshold_bin", "left_child",
                  "right_child", "decision_type")


def binned_table(trees: List[Tree], device=None) -> BinnedTrees:
    """The ``BinnedTrees`` of ``trees`` on ``device`` (the trees' own by
    default): the five int fields' used slices of every tree gathered in
    one concatenation on the device and the records made there, the child
    pointers moved to global rows; the per-node offsets, the roots and
    the per-tree offsets go up in one copy from pinned memory.  A single
    tree (each new tree's walk over the valid sets) needs no child
    offsets, and its leaf values are its own.  A split feature < 0 reads
    column 0, as the JAX walk's ``maximum(f, 0)``."""
    if device is None:
        device = trees[0].leaf_value.device if trees else "cpu"
    T = len(trees)
    nl = [max(int(t.num_leaves), 1) for t in trees]
    ni = [n - 1 for n in nl]
    node_off = np.concatenate([[0], np.cumsum(ni)]).astype(np.int64)
    leaf_off = np.concatenate([[0], np.cumsum(nl)]).astype(np.int64)
    if leaf_off[-1] >= _I32_MAX:
        raise ValueError("the ensemble has too many nodes for int32")
    root = [int(node_off[t]) if ni[t] else ~int(leaf_off[t])
            for t in range(T)]
    nodes = int(node_off[-1])
    moved = nodes if T > 1 else 0  # nodes whose children move
    # one int32 upload: each moved node's child offsets (an internal child
    # moves by its tree's first record, a leaf ~j by minus its first
    # leaf), the roots, the first records and the first leaves
    host = np.concatenate([np.repeat(node_off[:-1], ni)[:moved],
                           -np.repeat(leaf_off[:-1], ni)[:moved], root,
                           node_off, leaf_off]).astype(np.int32)
    meta = upload(host, device)
    tail = meta[2 * moved:]
    parts = [t.leaf_value[:c].to(device) for t, c in zip(trees, nl)]
    lv = (parts[0] if T == 1 else torch.cat(parts) if parts
          else torch.zeros(0, dtype=torch.float32, device=device))
    if nodes:
        f = torch.cat([getattr(t, field)[:c].to(device, torch.int32)
                       for field in _RECORD_FIELDS
                       for t, c in zip(trees, ni) if c]).view(5, nodes)
        ch = f[2:4]
        if moved:
            off = meta[:2 * moved].view(2, moved)
            ch = ch + torch.where(ch >= 0, off[0], off[1])  # ~(~c+L) == c-L
        feat = f[0].clamp(min=0)
        feat = torch.where(f[4] == 1, feat | _I32_MIN, feat)
        node = torch.stack([feat, f[1], ch[0], ch[1]], dim=1)
    else:
        node = torch.zeros((0, 4), dtype=torch.int32, device=device)
    return BinnedTrees(node, lv, root, max(ni, default=0), tail[:T],
                       tail[T:2 * T + 1], tail[2 * T + 1:])


def _bin_at(X_binT: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """``X_binT[feat[j], j]`` as int32 for every row j of ``[F, n]`` bins
    in their stored dtype: uint8, or uint16 gathered through an int16 view
    of the same bits (torch gathers no uint16)."""
    if X_binT.dtype == torch.uint16:
        v = X_binT.view(torch.int16).gather(0, feat[None])[0]
        return v.to(torch.int32) & 0xFFFF
    return X_binT.gather(0, feat[None])[0].to(torch.int32)


def binned_leaves(table: BinnedTrees, t: int,
                  X_binT: torch.Tensor) -> torch.Tensor:
    """Global leaf row of every row of ``[F, n]`` bins in tree ``t``: a
    lockstep walk (Tree::GetLeaf, tree.cpp:98-122), numerical nodes
    sending ``bin <= threshold_bin`` left, categorical ``bin ==
    threshold_bin``, until every row is at a leaf."""
    n = X_binT.shape[1]
    node = torch.full((n,), table.root[t], dtype=torch.int64,
                      device=X_binT.device)
    if table.root[t] < 0:
        return ~node
    rec = table.node.to(torch.int64)
    for _ in range(table.max_steps):
        active = node >= 0
        if not bool(active.any()):
            break
        r = rec[node.clamp(min=0)]
        b = _bin_at(X_binT, r[:, 0] & 0x7FFFFFFF)
        left = torch.where(r[:, 0] < 0, b == r[:, 1], b <= r[:, 1])
        node = torch.where(active, torch.where(left, r[:, 2], r[:, 3]), node)
    return ~node


def binned_update_(scores: torch.Tensor, table: BinnedTrees,
                   X_binT: torch.Tensor, c0: int,
                   scale: float) -> torch.Tensor:
    """Kernel P2's update mode, plain: for each tree t of ``table`` in
    order, ``scores[(c0 + t) % K] += f32(scale) * leaf_t(row)`` on the
    ``[K, n]`` f32 scores, in place, every product and every add a float32
    rounding of its own (the JAX package's eager ``s.at[c].add(f32(scale)
    * predict_binned(tree, X))``; scale 1 adds the leaf value, -1
    subtracts it).  The scale is a float32 0-d tensor on the host, so the
    product is the float32 one on either device, as P2's float argument
    gives it."""
    K = scores.shape[0]
    sc = torch.tensor(scale, dtype=torch.float32)
    for t in range(table.num_trees):
        vals = table.leaf_value[binned_leaves(table, t, X_binT)]
        scores[(int(c0) + t) % K] += vals * sc
    return scores


def binned_replay_(scores: torch.Tensor, table: BinnedTrees,
                   X_binT: torch.Tensor, num_class: int,
                   chunk_iters: int) -> torch.Tensor:
    """Kernel P2's replay mode, plain: the table's trees (iteration-major,
    tree i*K + k is class k's) added to the ``[K, n]`` scores in place in
    ``add_valid_dataset``'s float order (gbdt.py:478-489): each chunk of
    ``chunk_iters`` iterations summed from zero in tree order, and the
    chunk sums added in order."""
    K = int(num_class)
    n_iter = table.num_trees // K
    step = max(int(chunk_iters), 1)
    for lo in range(0, n_iter, step):
        part = torch.zeros_like(scores)
        for i in range(lo, min(lo + step, n_iter)):
            for k in range(K):
                part[k] = part[k] + table.leaf_value[
                    binned_leaves(table, i * K + k, X_binT)]
        scores += part
    return scores


# ------------------------------------------------------------- ensembles
@dataclasses.dataclass
class PackedTrees:
    """A whole ensemble as one flat node table: the used internal nodes of
    every tree one after the other, and their leaves likewise, so trees of
    different leaf budgets need no padding (the JAX package's
    ``pad_tree`` / ``stack_trees``).  Child pointers are global: an
    internal child is its row in the node table, a leaf child ``~j`` with
    ``j`` its row in ``leaf_value``.  ``root[t]`` is tree t's first node
    (``~leaf_offset[t]`` for a one-leaf tree).  ``depth`` is the deepest
    root-to-leaf path in internal nodes, the walk's step count.

    ``node`` holds each internal node once more as one 16-byte record,
    the layout kernel P1 reads with one load a visit: ``{split_feature |
    categorical << 31, the threshold's float32 bits, left_child,
    right_child}``; the plain versions read the separate arrays."""

    split_feature: torch.Tensor  # [nodes] int32, real column index
    threshold: torch.Tensor  # [nodes] f32, threshold_real
    decision_type: torch.Tensor  # [nodes] uint8, 0 numerical, 1 categorical
    left_child: torch.Tensor  # [nodes] int32, global
    right_child: torch.Tensor  # [nodes] int32, global
    leaf_value: torch.Tensor  # [leaves] f32
    root: torch.Tensor  # [T] int32
    leaf_offset: torch.Tensor  # [T] int32
    num_leaves: torch.Tensor  # [T] int32
    node: torch.Tensor  # [nodes, 4] int32, P1's record of each node
    node_offset: torch.Tensor  # [T + 1] int32, tree t's first record
    num_class: int
    depth: int
    num_features: int  # 1 + the largest split feature (0 without splits)
    max_tree_nodes: int  # the most internal nodes of one tree

    @property
    def num_trees(self) -> int:
        return int(self.root.shape[0])

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]


def _host(trees: List[Tree], field: str, counts: List[int]) -> np.ndarray:
    """The first ``counts[t]`` entries of ``field`` of every tree t, one
    host array (one device copy for the whole ensemble)."""
    parts = [getattr(t, field)[:c] for t, c in zip(trees, counts)]
    return torch.cat(parts).cpu().numpy() if parts else np.zeros(0)


def _tree_depth(lc: List[int], rc: List[int], t: int) -> int:
    """Depth in internal nodes of tree ``t`` with local child lists;
    raises on a pointer out of range or a node reached twice."""
    ni = len(lc)
    if ni == 0:
        return 0
    seen = [False] * ni
    stack, depth = [(0, 1)], 0
    while stack:
        node, d = stack.pop()
        if not 0 <= node < ni or seen[node]:
            raise ValueError(f"tree {t}: malformed child pointers at "
                             f"node {node}")
        seen[node] = True
        depth = max(depth, d)
        for c in (lc[node], rc[node]):
            if c >= 0:
                stack.append((c, d + 1))
            elif ~c > ni:  # a tree of ni internal nodes has ni + 1 leaves
                raise ValueError(f"tree {t}: leaf {~c} out of range")
    return depth


def pack_trees(trees: List[Tree], num_class: int = 1,
               device=None) -> PackedTrees:
    """The ``PackedTrees`` of ``trees`` (iteration-major for
    ``num_class`` > 1: tree i*K + k is class k's), on ``device`` (the
    trees' own by default).  The structure is checked on the host once,
    so no walk can leave its tree."""
    if device is None:
        device = trees[0].leaf_value.device if trees else "cpu"
    nl = [max(int(t.num_leaves), 1) for t in trees]
    ni = [n - 1 for n in nl]
    node_off = np.concatenate([[0], np.cumsum(ni)]).astype(np.int64)
    leaf_off = np.concatenate([[0], np.cumsum(nl)]).astype(np.int64)
    if leaf_off[-1] >= _I32_MAX:
        raise ValueError("the ensemble has too many nodes for int32")
    # a split feature < 0 reads column 0, as the JAX walk's maximum(f, 0)
    feat = np.maximum(_host(trees, "split_feature_real", ni), 0)
    thr = _host(trees, "threshold_real", ni)
    dt = _host(trees, "decision_type", ni)
    lc = _host(trees, "left_child", ni).astype(np.int64)
    rc = _host(trees, "right_child", ni).astype(np.int64)
    lv = _host(trees, "leaf_value", nl)
    depth = 0
    for t in range(len(trees)):
        a, b = node_off[t], node_off[t + 1]
        depth = max(depth, _tree_depth(lc[a:b].tolist(), rc[a:b].tolist(), t))
    # local -> global pointers: node c -> node_off + c, leaf ~j -> ~(leaf_off + j)
    tree_of = np.repeat(np.arange(len(trees)), ni)
    for ch in (lc, rc):
        ch[:] = np.where(ch >= 0, ch + node_off[tree_of],
                         ~(~ch + leaf_off[tree_of]))
    root = np.where(np.asarray(ni) > 0, node_off[:-1], ~leaf_off[:-1])

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    thr32 = np.ascontiguousarray(thr, np.float32)
    node = np.stack([feat.astype(np.int64) | np.where(dt == 1, CAT_BIT, 0),
                     thr32.view(np.int32), lc, rc], axis=1)
    node = node.astype(np.int64).astype(np.uint32).view(np.int32)

    return PackedTrees(
        split_feature=dev(feat, np.int32), threshold=dev(thr, np.float32),
        decision_type=dev(dt, np.uint8), left_child=dev(lc, np.int32),
        right_child=dev(rc, np.int32), leaf_value=dev(lv, np.float32),
        root=dev(root, np.int32), leaf_offset=dev(leaf_off[:-1], np.int32),
        num_leaves=dev(nl, np.int32), node=dev(node, np.int32),
        node_offset=dev(node_off, np.int32), num_class=int(num_class),
        depth=depth, max_tree_nodes=max(ni, default=0),
        num_features=int(feat.max()) + 1 if feat.size else 0)


# rows x trees walked at once by the plain versions: the JAX package's
# bound on one dispatch (GBDT._iter_chunk), so a walk's temporaries stay
# O(16M) elements whatever the ensemble's size
WALK_CELLS = 16_000_000


def _walk_packed(p: PackedTrees, X: torch.Tensor, t0: int,
                 t1: int) -> torch.Tensor:
    """Global leaf row ``[n, t1 - t0]`` of every row in trees ``t0`` to
    ``t1 - 1``: those trees in lockstep, ``p.depth`` steps."""
    n = X.shape[0]
    node = p.root[t0:t1].to(torch.int64).expand(n, t1 - t0).clone()
    feat = p.split_feature.to(torch.int64)
    is_cat = p.decision_type == 1
    any_cat = bool(is_cat.any())
    lch = p.left_child.to(torch.int64)
    rch = p.right_child.to(torch.int64)
    for _ in range(p.depth):
        idx = node.clamp(min=0)
        v = X.gather(1, feat[idx])
        t = p.threshold[idx]
        go_left = v <= t
        if any_cat:
            go_left = torch.where(
                is_cat[idx], f32_to_i32_xla(v) == f32_to_i32_xla(t), go_left)
        node = torch.where(node >= 0,
                           torch.where(go_left, lch[idx], rch[idx]), node)
    return ~node


def ensemble_sum_raw(p: PackedTrees, X: torch.Tensor, n_trees: int,
                     chunk_iters: int) -> torch.Tensor:
    """``[K, n]`` f32 raw scores of the first ``n_trees`` trees (whole
    iterations) on RAW features ``[n, F]`` f32: the plain version of
    kernel P1's sum mode (ops/predict.py).  Each class's leaf values are
    added in tree order into a sum that starts from zero every
    ``chunk_iters`` iterations, and the chunk sums are added in order —
    the JAX package's float order (``ensemble_sum_raw`` under
    ``GBDT._raw_scores``' iteration chunks).  Each chunk's trees are
    walked on their own, so the offline path (chunks of
    ``GBDT._iter_chunk`` iterations) never holds more than
    ``WALK_CELLS`` rows x trees."""
    K, n = p.num_class, X.shape[0]
    n_iter = n_trees // K
    step = max(int(chunk_iters), 1)
    acc = torch.zeros((K, n), dtype=torch.float32, device=X.device)
    for lo in range(0, n_iter, step):
        hi = min(lo + step, n_iter)
        vals = p.leaf_value[_walk_packed(p, X, lo * K, hi * K)]
        vals = vals.T.reshape(hi - lo, K, n)
        part = torch.zeros_like(acc)
        for i in range(hi - lo):
            part = part + vals[i]
        acc = acc + part
    return acc


def ensemble_leaves_raw(p: PackedTrees, X: torch.Tensor,
                        n_trees: int) -> torch.Tensor:
    """``[n_trees, n]`` int32 leaf index of every row in each of the first
    ``n_trees`` trees (PredictLeafIndex, gbdt.cpp:647-655): the plain
    version of kernel P1's leaves mode, walked ``WALK_CELLS // n`` trees
    at a time."""
    n = X.shape[0]
    out = torch.empty((n_trees, n), dtype=torch.int32, device=X.device)
    step = max(WALK_CELLS // max(n, 1), 1)
    for t0 in range(0, n_trees, step):
        t1 = min(t0 + step, n_trees)
        leaves = _walk_packed(p, X, t0, t1) - p.leaf_offset[t0:t1].to(
            torch.int64)
        out[t0:t1] = leaves.T.to(torch.int32)
    return out


# ---------------------------------------------------------------- thresholds
def pack_threshold_bounds(bin_thresholds: List[np.ndarray],
                          real_feature_indices, device="cpu"):
    """Per-feature bin upper bounds as one padded ``[F, Bmax]`` f32 matrix
    (+inf -> float32 max; bins past a feature's list reuse its last
    bound) plus the real-feature index vector."""
    F = len(bin_thresholds)
    bmax = max((len(b) for b in bin_thresholds), default=1)
    mat = np.full((max(F, 1), max(bmax, 1)), np.finfo(np.float32).max,
                  np.float32)
    for f, bounds in enumerate(bin_thresholds):
        for b, v in enumerate(bounds):
            mat[f, b] = (np.float32(v) if np.isfinite(v)
                         else np.finfo(np.float32).max)
        mat[f, len(bounds):] = mat[f, max(len(bounds) - 1, 0)]
    return (torch.from_numpy(mat).to(device),
            torch.from_numpy(np.asarray(real_feature_indices, np.int32))
            .to(device))


def finalize_thresholds_device(tree: Tree, bounds_mat: torch.Tensor,
                               real_feat: torch.Tensor) -> Tree:
    """Real thresholds from the bin upper bounds (numerical: the bin's
    upper bound, tree.cpp:70; categorical: the category) and real feature
    ids, as tensor ops (-1/0 on non-split nodes)."""
    sf = tree.split_feature.to(torch.int64)
    is_split = sf >= 0
    fc = sf.clamp(min=0)
    tb = tree.threshold_bin.to(torch.int64).clamp(0, bounds_mat.shape[1] - 1)
    tr = torch.where(is_split, bounds_mat[fc, tb],
                     torch.zeros((), dtype=torch.float32, device=sf.device))
    sfr = torch.where(is_split, real_feat[fc].to(torch.int32),
                      torch.full((), -1, dtype=torch.int32, device=sf.device))
    return tree.replace(threshold_real=tr.to(torch.float32),
                        split_feature_real=sfr)

