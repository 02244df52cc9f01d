"""Leaf-sorted packed training record: the record and mega routes' steps.

Counterpart of lightgbm_tpu/ops/record.py.  The record route keeps the
training rows physically in leaf order instead of permuting row ids: every
leaf owns one contiguous column range of a packed ``[W, n]`` int32 record,
so a split partitions one contiguous window in place and a child's
histogram reads one contiguous window.  Row meaning is the JAX package's:

    rows 0..Wb-1 : binned features, k per word (k=4 for u8 bins, k=2 for
                   u16; feature j*k+i in bits [i*32/k, (i+1)*32/k) of word j)
    row  Wb      : gradient (float32 bit pattern)
    row  Wb+1    : hessian (float32 bit pattern)
    row  Wb+2    : bagging mask (float32 bit pattern)
    row  Wb+3    : original row id
    row  Wb+4    : leaf id (stamped by every split over the parent's range)

Two differences from the JAX record, both TPU layout rules the port does
not need:

* W is not padded to a multiple of 8 (a Mosaic sublane rule,
  record.py:123-133): the port's record is exactly ``W = Wb + 5`` rows.
* There is no ``n_pad`` tail.  The JAX grower slices static capacity tiers
  and keeps the rows past a window's count untouched; the port slices each
  window's exact range, so the record is ``[W, n]``.

The split (``partition_window``) is the JAX package's
``partition_window`` + ``place_runs`` (record.py:1153, :914): per tile of
``TILE`` columns the columns going left are compacted stably to the front
of a ``[W-1, 2*TILE]`` run buffer and the columns going right behind them
(``compact_tiles``, kernel K6; the leaf-id row is stamped afresh, so it is
not carried), then every tile's left run is copied to
``begin + (lefts of the tiles before it)`` and its right run to ``begin +
nleft + (rights of the tiles before it)``, with the child leaf ids written
into the leaf-id row (``place_runs``, kernel K7).  The go flags come from
the split feature's packed word, as ``_tile_go`` computes them in the JAX
kernel.  The port's grower stops at the first step without a positive
gain, so every call is a real split: the JAX version's ``do_split`` mask is
dropped.

On CPU tensors ``partition_window`` runs the plain versions below; on CUDA
tensors it launches the two kernels (ops/cuda_record.py, csrc/record.cu).
The plain versions write the same bytes the kernels write, so a record
partitioned either way is bitwise the same.

The mega route's step (``split_step``) is the JAX package's
``split_step_window(..., return_comp=True)`` (record.py:994): the go
flags, the compacted tiles and their counts (K6's output), the left
child's histogram over the whole parent window, the subtraction, both
buffer rows and both searches in one call (kernel 8 on the card,
ops/cuda_split_step.py, csrc/split_step.cu); ``place_window`` (K7) then
places the tiles.  ``split_step_plain`` composes the plain versions.

``write_window`` writes a ``[W, cap]`` window back into the record at a
column offset (the JAX package's ``write_window``, record.py:618; kernel 9
on the card, ops/cuda_record.py; no learner calls it).
"""

from __future__ import annotations

import importlib

import torch

# columns per compaction tile; must equal kTile in csrc/record.cu
TILE = 512


# the CUDA wrapper modules by name, each imported once at its first use:
# each imports this module, so this one cannot import them at its top
_CUDA_MODULES = {}


def _cuda(name: str):
    mod = _CUDA_MODULES.get(name)
    if mod is None:
        mod = importlib.import_module(f"{__package__}.{name}")
        _CUDA_MODULES[name] = mod
    return mod


def bins_per_word(bin_dtype) -> int:
    return 4 if bin_dtype.itemsize == 1 else 2


def num_words(F: int, k: int) -> int:
    return -(-F // k)


def rec_height(F: int, k: int) -> int:
    """Record rows: the packed words + grad, hess, mask, row id, leaf id."""
    return num_words(F, k) + 5


def row_id_row(W: int) -> int:
    return W - 2


def leaf_row(W: int) -> int:
    return W - 1


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bins(bins_T: torch.Tensor) -> torch.Tensor:
    """[F, n] u8/u16 -> [Wb, n] int32, k features per word.  Packed one
    word at a time, so the int64 scratch is one [n] row, not [F, n]."""
    F, n = bins_T.shape
    k = bins_per_word(bins_T.dtype)
    shift = 32 // k
    out = torch.empty((num_words(F, k), n), dtype=torch.int32,
                      device=bins_T.device)
    for w in range(out.shape[0]):
        acc = bins_T[w * k].to(torch.int64)
        for j in range(1, min(k, F - w * k)):
            acc |= bins_T[w * k + j].to(torch.int64) << (shift * j)
        out[w] = _as_i32(acc)
    return out


def build_record(bins_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                 bag_mask: torch.Tensor) -> torch.Tensor:
    """The per-tree record in identity order, ``[W, n]`` int32."""
    n = grad.shape[0]

    def bits(v):
        return v.to(torch.float32).contiguous().view(torch.int32)[None]

    return torch.cat([
        pack_bins(bins_T), bits(grad), bits(hess), bits(bag_mask),
        torch.arange(n, dtype=torch.int32, device=grad.device)[None],
        torch.zeros((1, n), dtype=torch.int32, device=grad.device),
    ])


def extract_feature(rec: torch.Tensor, f: int, begin: int, cnt: int,
                    k: int) -> torch.Tensor:
    """Bin values of feature ``f`` over window ``[begin, begin+cnt)``
    (int32)."""
    shift = 32 // k
    word = rec[f // k, begin:begin + cnt]
    return (word >> ((f % k) * shift)) & ((1 << shift) - 1)


def unpack_window(win: torch.Tensor, F: int, k: int, bin_dtype):
    """``[W, cnt]`` record window -> (bins [F, cnt], grad, hess, mask)."""
    Wb = num_words(F, k)
    shift = 32 // k
    words = win[:Wb]
    parts = [(words >> (shift * j)) & ((1 << shift) - 1) for j in range(k)]
    bins = torch.stack(parts, dim=1).reshape(Wb * k, -1)[:F].to(bin_dtype)

    def f32(r):
        return win[r].contiguous().view(torch.float32)

    return bins, f32(Wb), f32(Wb + 1), f32(Wb + 2)


def _run_offsets(counts: torch.Tensor):
    """Exclusive per-tile start offsets of the left (row 0) and right
    (row 1) runs within their halves, from the per-tile counts [2, nt]
    (record.py:529), and the left total nleft as a 0-d view of the same
    scan.  The plain path's; K7 computes the same offsets itself."""
    incl = torch.cumsum(counts, 1, dtype=torch.int32)
    nleft = incl[0, -1] if counts.shape[1] else incl.new_zeros(())
    return incl - counts, nleft


def go_flags(rec: torch.Tensor, f: int, thr: int, is_cat: bool, begin: int,
             cnt: int, k: int) -> torch.Tensor:
    """Left-going flags of window ``[begin, begin+cnt)`` (bool):
    ``bin == thr`` for a categorical split, ``bin <= thr`` otherwise."""
    fv = extract_feature(rec, f, begin, cnt, k)
    return (fv == thr) if is_cat else (fv <= thr)


def compact_tiles(win: torch.Tensor, go: torch.Tensor):
    """Plain version of K6.  ``win`` [R, cnt] int32 (the record route
    passes a window's R = W-1 rows above the leaf id), ``go`` [cnt] bool.
    Per tile of TILE columns, the lefts land stably in ``[:, :TILE]`` and
    the rights in ``[:, TILE:]`` of ``comp [nt, R, 2*TILE]``; lanes past a
    run's count are zero here and unspecified in the kernel.  Returns
    (comp, cl [nt], cr [nt]) with int32 counts."""
    W, cnt = win.shape
    T = TILE
    nt = -(-cnt // T)
    dev = win.device
    pad = nt * T - cnt
    g = torch.cat([go.to(torch.int32),
                   torch.zeros(pad, dtype=torch.int32, device=dev)])
    v = torch.cat([torch.ones(cnt, dtype=torch.int32, device=dev),
                   torch.zeros(pad, dtype=torch.int32, device=dev)])
    g, v = g.reshape(nt, T), v.reshape(nt, T)
    r = v - g
    lpos = torch.cumsum(g, 1) - 1
    rpos = torch.cumsum(r, 1) - 1
    # invalid lanes go to a spill lane 2T that is cut off below
    dest = torch.where(g > 0, lpos, torch.where(r > 0, T + rpos, 2 * T))
    src = torch.cat([win, torch.zeros((W, pad), dtype=win.dtype, device=dev)],
                    1).reshape(W, nt, T).permute(1, 0, 2)
    comp = torch.zeros((nt, W, 2 * T + 1), dtype=win.dtype, device=dev)
    comp.scatter_(2, dest[:, None, :].expand(nt, W, T).to(torch.int64), src)
    return (comp[:, :, :2 * T].contiguous(), g.sum(1, dtype=torch.int32),
            r.sum(1, dtype=torch.int32))


def place_runs(rec: torch.Tensor, comp: torch.Tensor, cl: torch.Tensor,
               cr: torch.Tensor, begin: int, pcnt: int, nleft: int,
               left_leaf: int, right_leaf: int) -> None:
    """Plain version of K7, to ``_xla_place``'s contract
    (record.py:540-572), in place: the runs of ``comp [nt, W-1, 2*TILE]``
    go to rows ``[:W-1]``, lefts to ``[begin, begin+nleft)``, rights to
    ``[begin+nleft, begin+pcnt)``, each run in tile order, and the child
    ids into the leaf-id row (the record's last; the JAX version takes it
    as ``leaf_row``) over ``[begin, begin+pcnt)``.  Nothing outside the
    window changes."""
    lrow = leaf_row(rec.shape[0])
    T = TILE
    lane = torch.arange(T, device=rec.device)[None, :]
    lmask = lane < cl[:, None]  # [nt, T]
    rmask = lane < cr[:, None]
    lefts = comp[:, :, :T].permute(1, 0, 2)[:, lmask]  # [W-1, nleft]
    rights = comp[:, :, T:].permute(1, 0, 2)[:, rmask]
    if lefts.shape[1] != nleft or nleft + rights.shape[1] != pcnt:
        raise ValueError(f"runs hold {lefts.shape[1]} + {rights.shape[1]} "
                         f"columns, expected {nleft} + {pcnt - nleft}")
    rec[:lrow, begin:begin + pcnt] = torch.cat([lefts, rights], 1)
    rec[lrow, begin:begin + nleft] = left_leaf
    rec[lrow, begin + nleft:begin + pcnt] = right_leaf


def place_window(rec: torch.Tensor, comp: torch.Tensor, counts: torch.Tensor,
                 begin: int, pcnt: int, left_leaf: int,
                 right_leaf: int) -> torch.Tensor:
    """The runs of ``comp`` with their per-tile ``counts`` [2, nt] (K6's or
    K8's output for window ``[begin, begin+pcnt)``) placed back into that
    window of ``rec`` in place, the child ids stamped.  Returns nleft as a
    0-d tensor on the record's device.  A CPU record takes ``place_runs``,
    a CUDA record kernel 7."""
    if rec.device.type != "cpu":
        return _cuda("cuda_record").place_cuda(rec, comp, counts, begin,
                                               pcnt, left_leaf, right_leaf)
    nleft = _run_offsets(counts)[1]
    place_runs(rec, comp, counts[0], counts[1], begin, pcnt, int(nleft),
               left_leaf, right_leaf)
    return nleft


def write_window(rec: torch.Tensor, out_win: torch.Tensor,
                 begin: int) -> torch.Tensor:
    """``rec[:, begin:begin+cap] = out_win`` in place on the ``[W, n]``
    int32 record, ``cap = out_win.shape[1]``; returns ``rec``.  ``begin``
    is placed as ``jax.lax.dynamic_update_slice`` places it (the JAX
    ``write_window``'s semantics in interpret mode, record.py:628-629): a
    negative ``begin`` counts from the end (``begin + n``), then it is
    clamped to ``[0, n - cap]``.  A CPU record takes ``copy_`` into the
    slice (the plain version), a CUDA record kernel 9."""
    W, n = rec.shape
    if out_win.dim() != 2 or out_win.shape[0] != W \
            or out_win.shape[1] > n or out_win.dtype != rec.dtype:
        raise ValueError(f"out_win must be [{W}, cap <= {n}] {rec.dtype}, got "
                         f"{tuple(out_win.shape)} {out_win.dtype}")
    cap = out_win.shape[1]
    b = int(begin)
    b = min(max(b + n if b < 0 else b, 0), n - cap)
    if rec.device.type != "cpu":
        _cuda("cuda_record").write_window_cuda(rec, out_win, b)
    else:
        rec[:, b:b + cap].copy_(out_win)
    return rec


def partition_window(rec: torch.Tensor, f: int, thr: int, is_cat: bool,
                     begin: int, pcnt: int, left_leaf: int, right_leaf: int,
                     k: int) -> torch.Tensor:
    """Stably partition the parent's window ``[begin, begin+pcnt)`` of
    ``rec`` in place by the split (feature ``f``, bin threshold ``thr``,
    ``k`` bins per word): lefts first, then rights, each in their old
    order, and the child ids stamped into the leaf-id row.  Returns the
    left count as a 0-d tensor on the record's device; the caller reads
    it on the host to slice the smaller child.  A CPU record takes the
    plain versions, a CUDA record kernels 6 and 7."""
    if rec.device.type != "cpu":
        comp, counts = _cuda("cuda_record").compact_cuda(
            rec, f, thr, is_cat, begin, pcnt, k)
    else:
        go = go_flags(rec, f, thr, is_cat, begin, pcnt, k)
        comp, cl, cr = compact_tiles(
            rec[:leaf_row(rec.shape[0]), begin:begin + pcnt], go)
        counts = torch.stack([cl, cr])
    return place_window(rec, comp, counts, begin, pcnt, left_leaf,
                        right_leaf)


def split_step_plain(rec: torch.Tensor, hists: torch.Tensor, f: int,
                     thr: int, is_cat: bool, begin: int, pcnt: int,
                     parent: int, new_leaf: int, scal, meta: torch.Tensor,
                     k: int, num_bins: int):
    """Plain version of kernel 8: ``go_flags``; ``compact_tiles`` (K6's
    comp and counts); the left child's histogram, the record-window
    histogram of ``[begin, begin+pcnt)`` with the mask times go, summed in
    the kernel's 2048-column chunks from ``begin``; then ``search2_update``
    with the left child as the given one (``hists[parent]`` <- left,
    ``hists[new_leaf]`` <- parent - left, both searched).  Returns (comp,
    counts [2, nt], rows [2, 16]) with the left count in ``rows[0, 11]``
    (exact in float32 under the 2**24-row envelope).  The record is only
    read.

    Not carried over from the JAX ``split_step_window``: its [P, Fp, 4, Bp]
    histogram layout and the bin-0 totals it writes into padded features
    (record.py:505-516), the aliased record pass-through of ``direct_read``
    (:740-768, :1091-1097), and ``do_split`` (every call is a real
    split)."""
    from .histogram import histogram_record_window  # it imports this module
    from .split import search2_update

    F = hists.shape[1]
    if hists.shape[2] != num_bins:
        raise ValueError(f"hists has {hists.shape[2]} bins, not {num_bins}")
    go = go_flags(rec, f, thr, is_cat, begin, pcnt, k)
    comp, cl, cr = compact_tiles(
        rec[:leaf_row(rec.shape[0]), begin:begin + pcnt], go)
    h_left = histogram_record_window(rec, begin, pcnt, F, k, num_bins, go=go)
    rows = search2_update(hists, h_left, parent, new_leaf, True, scal, meta)
    rows[0, 11] = cl.sum()
    return comp, torch.stack([cl, cr]), rows


def split_step(rec: torch.Tensor, hists: torch.Tensor, f: int, thr: int,
               is_cat: bool, begin: int, pcnt: int, parent: int,
               new_leaf: int, scal, meta: torch.Tensor, k: int,
               num_bins: int):
    """One split step of the mega route over the parent's window ``[begin,
    begin+pcnt)``, split on feature ``f`` at bin ``thr``; ``hists`` [L, F,
    num_bins, 3] rows ``parent`` (the parent, then the left child) and
    ``new_leaf`` (the right child) are updated in place; ``scal`` and
    ``meta`` as for ``search2_rows``.  Returns (comp, counts, rows) as
    ``split_step_plain`` does; ``place_window`` then partitions the record.
    A CPU record takes the plain version, a CUDA record kernel 8."""
    if rec.device.type != "cpu":
        return _cuda("cuda_split_step").split_step_cuda(
            rec, hists, f, thr, is_cat, begin, pcnt, parent, new_leaf, scal,
            meta, k, num_bins)
    return split_step_plain(rec, hists, f, thr, is_cat, begin, pcnt, parent,
                            new_leaf, scal, meta, k, num_bins)
