"""Association, cluster combination and completion (port of
``continuous_clustering_tpu/ops/association.py``, the shipped schedule only).

Per column batch, in three parts that ``associate_and_complete`` calls in
order (the multi-sensor step calls them itself, so that the kernels run
once for all its streams):

1. ``window_arrays``: gather the halo + batch window (R, WCOL = H + B) from
   the ring, with the halo pre-merge of cells that already share a
   component (``L0``);
2. ``window_kernels``, once for any number of windows of one shape: wedge
   neighbour search -> forward edge bitmasks (kernel K1,
   ``cc_cuda.edge_bits_stacked``), then min-label connected components
   over each window (kernel K2, ``cc_cuda.window_cc_stacked``):
   column-major label ids, segmented row scan from round 0, column scan
   from round 1, no pointer jump, 64-round cap;
3. ``complete_association``: label -> slot FastSV union with full path
   compression, new-slot allocation, the aggregate fold, completion, the
   bounded ring clear and the overflow checks, all at K scale; with
   ``record_neighbor_stats``, the visited-neighbour counter
   (``neighbor_stats``).

Every masked scatter routes its masked lanes to one padding entry past the
end of the table (the JAX version drops out-of-bounds indices).  The FastSV
loops test for convergence on the host: one sync per iteration.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import Config

from ..utils.stats import TRACE, host_bool
from . import cc_cuda
from .state import I32_MAX, RingState, clear_columns_chunk, ring_put, ring_read

I32 = torch.int32


class CompleteResult(NamedTuple):
    state: RingState
    fu_old: torch.Tensor
    fu_new: torch.Tensor
    num_new_clusters: torch.Tensor
    cc_rounds: torch.Tensor


class Window(NamedTuple):
    """Halo + batch window of one association step."""

    xw: torch.Tensor        # (R, WCOL) f32, likewise yw, zw, incw
    yw: torch.Tensor
    zw: torch.Tensor
    incw: torch.Tensor
    active_w: torch.Tensor  # (R, WCOL) bool
    wcols: torch.Tensor     # (WCOL,) i32 global column per window column
    slot_h: torch.Tensor    # (R, H) i32 ring slots of the halo
    L0: torch.Tensor        # (R, WCOL) i32 initial labels (column-major ids)
    mad: torch.Tensor       # (R, B) f32 asin(max_d / dist)
    wp: torch.Tensor        # (R, B) i32 wedge width in columns


class WindowCC(NamedTuple):
    """K1's and K2's results for one window."""

    bits: torch.Tensor       # (H+1, 2, R, B) i32 forward edge bitmasks
    labels: torch.Tensor     # (R, WCOL) i32 component labels
    converged: torch.Tensor  # () bool
    rounds: torch.Tensor     # () i32


def _scatter(table: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, reduce: str,
             pad) -> torch.Tensor:
    """Scatter-``reduce`` of ``src`` into a copy of ``table`` at ``idx``;
    entries with ``idx == len(table)`` land on a padding slot that is cut
    off (the JAX ``mode="drop"``)."""
    t = torch.cat([table, table.new_full((1,), pad)])
    t.scatter_reduce_(0, idx.reshape(-1).to(torch.int64), src.reshape(-1),
                      reduce, include_self=True)
    return t[:-1]


def _set_true(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    t = torch.cat([table, table.new_zeros(1)])
    t[idx.to(torch.int64)] = True
    return t[:-1]


def _f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> i32 key (a <= b iff key(a) <= key(b))."""
    b = x.contiguous().view(I32)
    return torch.where(b >= 0, b, -(2**31) - b)


def _f32_from_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, -(2**31) - k).contiguous().view(torch.float32)


def window_arrays(config: Config, state: RingState, gcol0, n_cols, B: int) -> Window:
    """Gather the window, the active mask, the halo pre-merged labels and the
    per-point wedge quantities."""
    cl = config.clustering
    H, K = cl.max_steps_in_row, cl.max_active_components
    R, rc = state.num_rows, state.ring_cols
    dev = state.device
    WCOL = H + B
    wcols = gcol0 - H + torch.arange(WCOL, dtype=I32, device=dev)
    lc0 = (gcol0 - H) % rc

    def take(arr):
        return ring_read(arr, lc0, WCOL)

    xw, yw, zw, incw = take(state.x), take(state.y), take(state.z), take(state.inclination)
    distw, gcolw, ignw = take(state.distance), take(state.gcol), take(state.is_ignored)
    # frozen halo cells: their (one-hop resolved) component is finished.
    # Batch columns may still hold stale slots from a rotation ago, so only
    # the halo's slots are read.
    slot_h = ring_read(state.slot, lc0, H)
    slot_res = state.slot_parent[slot_h.clamp_min(0).long()]
    froz_h = (slot_h >= 0) & state.slot_finished[slot_res.long()]
    frozw = torch.cat([froz_h, torch.zeros((R, B), dtype=torch.bool, device=dev)], dim=1)
    col_ok = (wcols >= state.first_unpublished) & (wcols < gcol0 + n_cols)
    active_w = (gcolw == wcols[None, :]) & ~ignw & ~frozw & col_ok[None, :]

    # column-major cell ids c * R + r; halo cells sharing a component start
    # at the component's minimum halo id
    ah = active_w[:, :H] & (slot_h >= 0)
    rr = torch.arange(R, dtype=I32, device=dev)[:, None]
    wlid_h = rr + torch.arange(H, dtype=I32, device=dev)[None, :] * R
    wlid_b = rr + torch.arange(H, WCOL, dtype=I32, device=dev)[None, :] * R
    m_slot = _scatter(torch.full((K,), R * WCOL, dtype=I32, device=dev),
                      torch.where(ah, slot_res, K), wlid_h, "amin", R * WCOL)
    pre = m_slot[slot_res.clamp(0, K - 1).long()]
    L0 = torch.cat([torch.where(ah, torch.minimum(pre, wlid_h), wlid_h), wlid_b], dim=1)

    # asin in f64, rounded once: the CPU and the card then agree bit for
    # bit (their f32 asin differ in the last ulp; XLA's differs from both by
    # up to 2 ulp)
    max_d = float(np.float32(cl.max_distance))
    mad = torch.asin((max_d / distw[:, H:]).to(torch.float64)).to(torch.float32)
    az_width = float(np.float32(2.0 * math.pi / config.range_image.num_columns))
    # NaN mad (empty or too-close cells) never reaches an edge: such points
    # are inactive, and only active points' wedge widths are read
    wp = torch.clamp(torch.nan_to_num(torch.ceil(mad / az_width), nan=0.0), max=H).to(I32)
    return Window(xw, yw, zw, incw, active_w, wcols, slot_h, L0, mad, wp)


def window_kernels(config: Config, wins: Sequence[Window]) -> List[WindowCC]:
    """K1, then K2, each launched once for all of ``wins`` (windows of one
    shape, one per stream).  Nothing is read back to the host: each
    window's widest wedge stays a device tensor."""
    cl = config.clustering
    H, V = cl.max_steps_in_row, cl.max_steps_in_column

    def stack(name):
        ts = [getattr(w, name) for w in wins]
        return ts[0][None] if len(ts) == 1 else torch.stack(ts)

    active_w, wp = stack("active_w"), stack("wp")
    max_d = np.float32(cl.max_distance)
    bits = cc_cuda.edge_bits_stacked(stack("xw"), stack("yw"), stack("zw"), stack("incw"),
                                     active_w, stack("mad"), wp, H=H, V=V,
                                     max_d2=float(max_d * max_d))
    max_wp = torch.where(active_w[:, :, H:], wp, 0).amax(dim=(1, 2)).to(I32)
    labels, converged, rounds = cc_cuda.window_cc_stacked(bits, stack("L0"), max_wp, H=H, V=V)
    return [WindowCC(bits[s], labels[s], converged[s], rounds[s]) for s in range(len(wins))]


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each i32 word, as i64."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def neighbor_stats(config: Config, state: RingState, win: Window,
                   bits: torch.Tensor) -> torch.Tensor:
    """The ``record_neighbor_stats`` counters (R, B) i32 of the batch points,
    0 for inactive ones: the low 16 bits count the cells the reference's
    wedge walk visits (…cpp:725), the high 16 the edges found, which are
    the set bits of K1's ``bits`` (the CC analog of the tree-child count).

    The JAX package's XLA formulation (``ops/association.py:438-474``), one
    column offset at a time: a cell is visited iff every cell strictly
    earlier in its walk passed the inclination test (the breaking cell
    itself counts) and its row is inside the window; the wedge spans
    ``dc <= wp`` and columns at or past the publish frontier.  Exact for
    ``stop_after_association_enabled=False`` (the reference's stop heuristic
    visits a data-dependent subset)."""
    cl = config.clustering
    H, V = cl.max_steps_in_row, cl.max_steps_in_column
    R, WCOL = win.incw.shape
    B = WCOL - H
    dev = win.incw.device
    nan_rows = torch.full((V, WCOL), float("nan"), dtype=torch.float32, device=dev)
    incp = torch.cat([nan_rows, win.incw, nan_rows])
    incb = win.incw[:, H:]
    k = torch.arange(1, V + 1, device=dev)[:, None, None]
    r = torch.arange(R, device=dev)[None, :, None]
    up_inb, dn_inb = r - k >= 0, r + k <= R - 1          # (V, R, 1)
    fu0 = state.first_unpublished.clamp_min(0)
    gcol_b = win.wcols[H:]

    def exclusive_cumprod(seq):  # along the walk, 1 before its first step
        c = torch.cumprod(seq.to(torch.int32), 0)
        return torch.cat([torch.ones_like(c[:1]), c[:-1]])

    visited = torch.zeros((R, B), dtype=torch.int32, device=dev)
    for dc in range(H + 1):
        # neighbours (r + dr, H + b - dc) for dr = -V..V: (2V + 1, R, B)
        ninc = torch.stack([incp[j:j + R, H - dc:H - dc + B] for j in range(2 * V + 1)])
        ok = ~(torch.abs(ninc - incb[None]) > win.mad[None])
        s_up = torch.where(up_inb, exclusive_cumprod(torch.flip(ok[:V], [0])), 0).sum(0)
        s_dn = torch.where(dn_inb, exclusive_cumprod(ok[V + 1:]), 0).sum(0)
        per_dc = s_up if dc == 0 else 1 + ok[V].to(torch.int64) * s_up + s_dn
        gate = (dc <= win.wp) & (gcol_b - dc >= fu0)[None, :]
        visited += torch.where(gate, per_dc, 0).to(torch.int32)
    degree = _popcount(bits).sum(dim=(0, 1))
    return torch.where(win.active_w[:, H:], visited + (degree << 16), 0).to(I32)


def associate_and_complete(config: Config, state: RingState, gcol0, n_cols,
                           batch_size: int) -> CompleteResult:
    """Association (CC update) and completion for one column batch; updates
    the ring and the state in place and returns the frontier results."""
    win = window_arrays(config, state, gcol0, n_cols, batch_size)
    with TRACE.span("step.association.cc", state.device):
        cc, = window_kernels(config, [win])
    return complete_association(config, state, gcol0, n_cols, batch_size, win, cc)


def complete_association(config: Config, state: RingState, gcol0, n_cols, batch_size: int,
                         win: Window, cc: WindowCC, *, ring_capacity: Optional[int] = None,
                         skip_clear: bool = False) -> CompleteResult:
    """Everything of association after the kernels, for the window ``win``
    and its kernel results ``cc``; updates the ring and the state in place
    and returns the frontier results.

    ``ring_capacity``/``skip_clear`` run the step on the halo path's
    window-sized scratch ring (``parallel/halo.py``): ``ring_capacity`` is
    the real ring's column count for the overflow check, and ``skip_clear``
    advances ``ring_start`` as the bounded clear would without touching a
    cell (the caller clears the real ring with the same gcol gate)."""
    cl = config.clustering
    H, K = cl.max_steps_in_row, cl.max_active_components
    R, rc, B = state.num_rows, state.ring_cols, batch_size
    dev = state.device
    num_cols = config.range_image.num_columns
    WCOL = H + B
    idxK = torch.arange(K, dtype=I32, device=dev)
    active_b = win.active_w[:, H:]
    Lw, cc_ok, cc_rounds = cc.labels, cc.converged, cc.rounds
    # read before completion moves the publish frontier
    nbr = neighbor_stats(config, state, win, cc.bits) if cl.record_neighbor_stats else None

    # ---- window labels -> component slots (id space = column-major) -------
    n_wc = R * WCOL
    self_wl = torch.arange(n_wc, dtype=I32, device=dev)
    lab = Lw.t().reshape(-1)
    activef = win.active_w.t().reshape(-1)
    lab_b = Lw[:, H:]
    slot_hf = win.slot_h.reshape(-1)
    lab_h = Lw[:, :H].reshape(-1)
    has_slot = win.active_w[:, :H].reshape(-1) & (slot_hf >= 0)

    fu_old = state.first_unpublished
    newest_gcol = gcol0 + n_cols - 1
    has_data = (fu_old >= 0) & (newest_gcol >= fu_old)

    # per-label minimum existing (resolved) slot: hub of an edge star joining
    # every slotted member to its label
    rs0 = torch.where(has_slot, state.slot_parent[slot_hf.clamp_min(0).long()], K)
    m0 = _scatter(torch.full((n_wc,), K, dtype=I32, device=dev),
                  torch.where(has_slot, lab_h, n_wc), rs0, "amin", K)
    m0lab = m0[torch.where(has_slot, lab_h, 0).long()]
    edge_ok = has_slot & (m0lab < rs0)
    ea = torch.where(edge_ok, rs0, 0).long()
    eb = torch.where(edge_ok, m0lab, 0).long()

    # FastSV union (at most 32 rounds), then full path compression: the
    # table leaves this function fully compressed (one-hop resolve)
    slot_parent = state.slot_parent
    changed, it = host_bool(edge_ok.any()), 0
    while changed and it < 32:
        ra = slot_parent[slot_parent[ea].long()]
        rb = slot_parent[slot_parent[eb].long()]
        lo, hi = torch.minimum(ra, rb), torch.maximum(ra, rb)
        do = edge_ok & (lo != hi)
        p2 = _scatter(slot_parent, torch.where(do, hi, K), lo, "amin", K)
        p2 = p2[p2.long()]
        changed, it = host_bool((p2 != slot_parent).any()), it + 1
        slot_parent = p2
    TRACE.count("step.fastsv_rounds", it)
    while True:
        p2 = slot_parent[slot_parent.long()]
        done = host_bool((p2 == slot_parent).all())
        slot_parent = p2
        if done:
            break

    # ---- batch contributions ------------------------------------------------
    lc0b = gcol0 % rc
    finish_b = ring_read(state.cont_az, lc0b, B) + win.mad

    # ---- allocate slots for brand-new components (slotless representatives)
    is_rep = activef & (lab == self_wl)
    need_new = is_rep & (m0 >= K)
    within = torch.cumsum(need_new.reshape(WCOL, R).to(I32), dim=0, dtype=I32)
    ctot = within[-1]
    coff = torch.cumsum(ctot, dim=0, dtype=I32) - ctot
    new_rank = (within + coff[None, :]).reshape(-1)
    n_new = coff[-1] + ctot[-1]
    free = ~state.slot_live
    free_rank = torch.cumsum(free.to(I32), dim=0, dtype=I32)
    n_free = free_rank[-1]
    slot_overflow = has_data & (n_new > n_free)
    free_compact = torch.zeros(K + 1, dtype=I32, device=dev)
    free_compact.scatter_(0, torch.where(free, free_rank - 1, K).long(), idxK)
    free_compact = free_compact[:K]
    gidx = torch.where(need_new, (new_rank - 1).clamp(0, K - 1), K + m0.clamp(0, K - 1))
    slot_of_label = torch.cat([free_compact, slot_parent])[gidx.long()]
    cs_b2d = torch.where(active_b, slot_of_label[lab_b.long()], -1)

    wmask = (torch.arange(B, device=dev) < n_cols)[None, :].expand(R, B)
    ring_put(state.slot, lc0b, wmask, cs_b2d)
    ring_put(state.finish_az, lc0b, wmask & active_b, finish_b)
    if nbr is not None:
        ring_put(state.nbr_stats, lc0b, wmask, nbr)

    # ---- fold demoted canonicals (an identity when nothing was demoted) ---
    demote = state.slot_valid & (slot_parent != idxK)
    tgtd = torch.where(demote, slot_parent, K)
    fin_t = torch.where(demote, -math.inf, _scatter(
        state.slot_finish, tgtd, state.slot_finish, "amax", -math.inf))
    gmin_t = torch.where(demote, I32_MAX, _scatter(
        state.slot_gmin, tgtd, state.slot_gmin, "amin", I32_MAX))
    gmax_t = torch.where(demote, -1, _scatter(
        state.slot_gmax, tgtd, state.slot_gmax, "amax", -1))
    cnt_t = torch.where(demote, 0, _scatter(
        state.slot_count, tgtd, torch.where(demote, state.slot_count, 0), "sum", 0))
    valid_t = state.slot_valid & ~demote

    alloc_idx = torch.where(idxK < torch.minimum(n_new, n_free), free_compact, K)
    live_t = _set_true(state.slot_live, alloc_idx)
    valid_t = _set_true(valid_t, alloc_idx)
    tgt_new = torch.where(need_new, slot_of_label, K)
    # representative = the component's minimum-column member; its ring glid
    rep_glid = (self_wl % R) * rc + (gcol0 - H + self_wl // R) % rc

    # batch contributions scatter straight into the K table keyed by each
    # cell's final slot; batch ids are the contiguous id tail [H*R:)
    cs_b = cs_b2d.reshape(-1)
    cs_idx = torch.where(cs_b >= 0, cs_b, K)
    gw_b = win.wcols[None, H:].expand(R, B).reshape(-1)
    fin_t = _f32_from_key(_scatter(_f32_sort_key(fin_t), cs_idx,
                                   _f32_sort_key(finish_b.reshape(-1)), "amax", 0))
    gmax_t = _scatter(gmax_t, cs_idx, gw_b, "amax", -1)
    # set == max for the representative: freed slots reset rep to -1
    rep_t = _scatter(state.slot_rep, torch.where(need_new[H * R:], tgt_new[H * R:], K),
                     rep_glid[H * R:], "amax", -1)
    cnt_t = _scatter(cnt_t, cs_idx, (cs_b >= 0).to(I32), "sum", 0)
    # a new slot's gmin is its representative's column (batch cells never
    # lower an existing slot's gmin)
    is_new_alloc = live_t & ~state.slot_live
    gmin_t = torch.where(is_new_alloc, gcol0 + (rep_t % rc - gcol0) % rc, gmin_t)

    # ---- completion, all K-sized -------------------------------------------
    newest = newest_gcol.clamp_min(0) % rc
    cur_min_az = state.cont_az[:, newest.long()].min()
    ring_start_old = state.ring_start
    clear_bound_old = torch.where(state.clear_bound >= 0, state.clear_bound, fu_old)

    live, valid, finished, cid = live_t, valid_t, state.slot_finished, state.slot_cid
    cand = live & valid & ~finished
    finished_new = cand & ((fin_t <= cur_min_az) | ((gmax_t + 1 - gmin_t) >= num_cols)) & has_data
    publish = finished_new & (cnt_t > 5)
    rank = torch.cumsum(publish.to(I32), dim=0, dtype=I32)
    num_new = torch.where(has_data, rank[-1], 0).to(I32)
    cid = torch.where(publish, state.cluster_counter + rank - 1, cid)
    finished = finished | finished_new
    # frontier advance: minimum over components unfinished entering this
    # completion, including just-finished ones (one-round publish hold)
    min_required = torch.where(cand, gmin_t, I32_MAX).min()
    min_required = torch.where(min_required == I32_MAX, gcol0 + n_cols, min_required)
    fu_new = torch.where(has_data, torch.maximum(fu_old, min_required), fu_old).to(I32)
    # free slots whose cells the ring clear has passed; forwarders go with
    # their canonical
    freed_canon = live & valid & finished & (gmax_t < ring_start_old)
    freed = live & freed_canon[slot_parent.long()]
    done = (live & ~freed, valid & ~freed, finished & ~freed,
            torch.where(freed, 0, cid), torch.where(freed, idxK, slot_parent),
            torch.where(freed, -math.inf, fin_t), torch.where(freed, I32_MAX, gmin_t),
            torch.where(freed, -1, gmax_t), torch.where(freed, 0, cnt_t),
            torch.where(freed, -1, rep_t))
    nth = cl.cluster_point_trees_every_nth_column
    if nth > 1:
        # tree combination every nth column: completion runs when the batch
        # holds a multiple of nth, or on an empty finalization kick
        end = gcol0 + n_cols - 1
        contains_nth = (end // nth) >= (gcol0 + nth - 1) // nth
        did = ((n_cols == 0) | contains_nth) & has_data
        skipped = (live_t, valid_t, state.slot_finished, state.slot_cid, slot_parent,
                   fin_t, gmin_t, gmax_t, cnt_t, rep_t)
        done = tuple(torch.where(did, a, b) for a, b in zip(done, skipped))
        num_new = torch.where(did, num_new, 0)
        fu_new = torch.where(did, fu_new, fu_old)

    # clear bookkeeping advances every step: the target trails the frontier
    # by one rotation and never passes the previous step's frontier
    clear_target_new = torch.where(
        has_data,
        torch.maximum(torch.clamp_min(torch.minimum(fu_new - num_cols, clear_bound_old), 0),
                      state.clear_target),
        state.clear_target).to(I32)
    clear_bound_new = torch.where(has_data, fu_old, clear_bound_old).to(I32)
    # writing column g reuses the cell of g - rc, which must be published
    # and already cleared
    rcap = rc if ring_capacity is None else ring_capacity
    window_overflow = has_data & ((newest_gcol - rcap >= fu_old)
                                  | ((ring_start_old >= 0) & (newest_gcol - rcap >= ring_start_old)))

    (state.slot_live, state.slot_valid, state.slot_finished, state.slot_cid,
     state.slot_parent, state.slot_finish, state.slot_gmin, state.slot_gmax,
     state.slot_count, state.slot_rep) = (
        t.to(d) for t, d in zip(done, (torch.bool,) * 3 + (I32, I32, torch.float32) + (I32,) * 4))
    state.cluster_counter = (state.cluster_counter + num_new).to(I32)
    state.first_unpublished = fu_new
    state.clear_bound = clear_bound_new
    state.clear_target = clear_target_new
    state.overflow = state.overflow | window_overflow | slot_overflow
    state.cc_failed = state.cc_failed | (has_data & ~cc_ok)
    if skip_clear:
        cleared_to = (ring_start_old
                      + torch.clamp(clear_target_new - ring_start_old, 0, B)).to(I32)
    else:
        state, cleared_to = clear_columns_chunk(state, ring_start_old, clear_target_new, B)
    state.ring_start = cleared_to
    return CompleteResult(state=state, fu_old=fu_old, fu_new=fu_new,
                          num_new_clusters=num_new, cc_rounds=cc_rounds)
