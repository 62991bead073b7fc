"""Whole-window POA on the GPU: the fused engine.

The cudapoa-shaped design (reference src/cuda/cudabatch.cpp:77-270: fill
a batch with windows, then one generate_poa() builds every window's
whole graph on the device), ported from the JAX package's fused engine
(racon_tpu/ops/poa_fused.py). Where the session engine
(ops/poa_graph.DeviceGraphPOA) goes back to the host once per layer
wave, this engine runs all layers of a chunk of windows on the device:
the POA graph lives in fixed-shape device arrays and is updated there.

  - topological order without a graph walk: every column owns a 64-bit
    order key, and node order is the sort of (column key, node id);
    insertion columns get keys strictly between their path neighbours'
    (run-partitioned equal spacing, the low 8 bits salted by the layer
    index);
  - per layer: the graph-NW DP and its traceback (the host engine's band
    rule, with the banded clipped -> full-DP retry), then the ingest:
    target resolution, node and column allocation, edge and weight
    wiring (w[i-1] + w[i]) and sequence counts;
  - windows that exceed an envelope (nodes, columns, in-degree P, key
    spacing, a predecessor more than RING ranks back) raise a per-window
    `failed` flag and leave the device;
  - the consensus runs on the host from the fetched arrays through the
    host engine's heaviest-bundle (native.poa_finish_arrays).

`fused_raw` below is the plain PyTorch version of the device program,
written with whole-batch tensor ops as the JAX program is: the CPU
tests hold it against the JAX `fused_raw` array for array. On a card the
program is the hand-written CUDA kernel K3 (csrc/poa_fused.cu, wrapper
ops/poa_fused_kernels.fused_layers), held against this version.

Depth is bucketed (DEPTH_BUCKETS layers per call) and deeper windows
chain calls with the state carried over and a layer-index base. With
the fused posture (`fused="1"`) one launch runs a chunk's whole chain,
the window slicing (spanning / bpos range / band rule) derived on the
device from the raw layer coordinates; with `fused="0"` the host slices
and each chained call is one launch. Both give the same bytes. `auto`
dispatches the autotuner's measured winner per leading depth bucket
(sched/autotune.py, engine "fused_loop"), and split where the table has
no entry.

`FusedPOA` drives the chunks through the dispatch pipeline; a device
failure raises (the JAX package's fused -> split -> host ladder is not
carried). Windows the engine leaves (its envelope, or `failed`) go back
to the caller, or with `fallback=True` to the host engine.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..device import resolve
from ..obs import trace
from ..utils.logger import Logger
from .dtypes import NEG16, kernel_plan, poa_int16_ok
from .poa_graph import (MAX_LEN, MAX_NODES, MAX_PRED, RING, device_budget,
                        pin_pow2_rows)

#: layers per call; deeper windows chain calls with carried state
DEPTH_BUCKETS = (8, 16, 32, 64)

#: deepest chunk one fused launch takes; deeper chunks run split
FUSED_LOOP_MAX_DEPTH = 128

_NEG = -(1 << 29)

#: the composite sort key (column key << 11 | node id) must fit int64
MAXKEY = 1 << 44

#: the names of the state arrays, in the program's argument order
STATE = ("codes", "preds", "predw", "nseq", "col_of", "colkey", "colnodes",
         "bpos", "n_nodes", "n_cols", "failed")


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """argmax of a bool mask along `dim` (at most 127 long): the first
    True, else 0. Weighted int8 max: CPU reductions of int64 along an
    inner dim are slow."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    w = torch.arange(n, 0, -1, dtype=torch.int8,
                     device=mask.device).reshape(shape)
    top = (mask.to(torch.int8) * w).amax(dim=dim).to(torch.int64)
    return torch.where(top > 0, n - top, 0)


def _scan_last(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 1 of (value, flag) pairs under the JAX
    program's `fwd`: the value of the last flagged position so far, or
    position 0's value where none is flagged yet."""
    idx = torch.arange(v.shape[1], device=v.device)[None, :]
    last = torch.cummax(torch.where(f, idx, 0), dim=1).values
    return torch.gather(v, 1, last)


def _scan_seg_max(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 1 under the JAX program's `bwd_seg`: the
    running max of v since the last flagged position (which restarts it
    at its own value). v is non-negative and below 1 << 20."""
    seg = torch.cumsum(f.to(torch.int64), dim=1)
    key = seg * (1 << 20) + v.to(torch.int64)
    return torch.cummax(key, dim=1).values - seg * (1 << 20)


def fused_raw(n_nodes: int, seq_len: int, depth: int, max_pred: int,
              match: int, mismatch: int, gap: int,
              banded_only: bool = False, score_dtype: str = "int32",
              device_slice: bool = False):
    """The plain PyTorch whole-window POA program for one (N, L, D, P)
    shape: the same function as the JAX package's `fused_raw` and the
    kernel K3.

    State tensors (leading dim B): codes [B,N] int8 (-1 free), preds
    [B,N,P] int16 node ids (-1 empty), predw [B,N,P] int32, nseq [B,N]
    int32, col_of [B,N] int16, colkey [B,N] int64, colnodes [B,N,5]
    int16, bpos [B,N] int16, n_nodes/n_cols [B] int32, failed [B] bool.
    Layer inputs: seqs [B,D,L] int8 (pad 5), lens [B,D] int32 (0 = no
    layer), wts [B,D,L] int8, then rlo/rhi [B,D] int16 (the layer's bpos
    range; -32768/32767 = spanning) and band [B,D] int32, or with
    `device_slice` begins/ends [B,D] int32 and bblen/offs [B] int32,
    from which each step derives rlo/rhi/band as the host packer does;
    lbase [B] int32 is the per-row layer-index base. Returns the new
    state tuple (the inputs are not changed).

    The DP runs in int32 and stores at the score dtype: 'int16' (legal
    only under dtypes.poa_int16_ok) stores int16 rows with the sentinel
    NEG16, and by the overflow proof gives the integers of the JAX int16
    program.
    """
    N, L, D, P = n_nodes, seq_len, depth, max_pred
    C = N
    W = RING
    dt = torch.int16 if score_dtype == "int16" else torch.int32
    neg_v = NEG16 if score_dtype == "int16" else _NEG
    i32, i64 = torch.int32, torch.int64

    def dp_align(codes_r, preds_r, sinks_r, centers_r, band, seq, slen,
                 kmax):
        dev = codes_r.device
        B = codes_r.shape[0]
        neg = torch.tensor(neg_v, dtype=i32, device=dev)
        jidx = torch.arange(L + 1, dtype=i32, device=dev)
        jg = jidx * gap
        h0 = torch.where(jidx[None, :] <= slen[:, None], jg[None, :], neg)
        # the ring of the last W rows (slot 0 = the virtual source), as
        # the JAX program carries it: a predecessor more than W ranks
        # back fails its window, one later in rank order reads the slot
        # as it stands
        H = torch.full((B, W + 1, L + 1), neg_v, dtype=dt, device=dev)
        H[:, 0] = h0.to(dt)
        scores = torch.full((B, N), neg_v, dtype=i32, device=dev)
        bps = torch.zeros((B, N, L + 1), dtype=torch.int8, device=dev)
        # per-row operands for every row at once: predecessor slots and
        # validity, code, band window; the loop below then runs few ops
        # a row
        seq32 = seq.to(i32)
        slen64 = slen.to(i64)
        codes32 = codes_r.to(i32)
        preds64 = preds_r.to(i64)
        valid = (preds64 >= 0)[:, :, :, None]
        slot = torch.where(preds64 > 0, 1 + torch.remainder(preds64 - 1, W),
                           0)[:, :, :, None]
        band2 = (band // 2)[:, None]
        use_band = (band > 0)[:, None]
        jlo = torch.where(use_band, (centers_r - band2).clamp(min=1), 1)
        jhi = torch.where(use_band,
                          torch.minimum(slen[:, None], centers_r + band2),
                          slen[:, None])
        seed_on = jlo == 1
        j1 = jidx[None, 1:]
        pidx = torch.arange(P, dtype=torch.int8, device=dev)[None, :]
        vidx = (pidx + P)[:, :, None]
        no_bp = torch.tensor(2 * P, dtype=torch.int8, device=dev)
        for k in range(1, kmax + 1):
            r = k - 1
            rows = torch.gather(H, 1, slot[:, r].expand(B, P, L + 1)).to(i32)
            rows = torch.where(valid[:, r], rows, neg)
            sub = torch.where(seq32 == codes32[:, r, None], match, mismatch)
            diag = rows[:, :, :-1] + sub[:, None, :]
            vert = rows[:, :, 1:] + gap
            best = torch.maximum(diag, vert).amax(dim=1)
            col0 = rows[:, :, 0] + gap
            row0 = col0.amax(dim=1)
            inb = (j1 >= jlo[:, r, None]) & (j1 <= jhi[:, r, None])
            seed0 = torch.where(seed_on[:, r], row0, neg)
            cat = torch.cat([seed0[:, None], torch.where(inb, best, neg)],
                            dim=1)
            run = torch.cummax(cat - jg, dim=1).values + jg
            hrow = torch.where(inb, run[:, 1:], neg)
            new_row = torch.cat([row0[:, None], hrow], dim=1)

            # backpointers: the first predecessor slot with a diagonal
            # hit, else the first with a vertical hit, else horizontal
            # (2P): the least of p for a diagonal hit, P + p for a
            # vertical one; column 0 takes P + the first vertical hit
            h3 = hrow[:, None, :]
            bpc = torch.where(h3 == diag, pidx[:, :, None],
                              torch.where(h3 == vert, vidx, no_bp)).amin(1)
            v0 = torch.where(row0[:, None] == col0, pidx, P).amin(1)
            bp0 = P + torch.where(v0 < P, v0, 0)
            bps[:, r] = torch.cat([bp0[:, None], bpc], dim=1)
            H[:, 1 + r % W] = new_row.to(dt)
            scores[:, r] = torch.gather(new_row, 1, slen64[:, None])[:, 0]

        cand = torch.where(sinks_r, scores, neg)
        best_rank = torch.argmax(cand, dim=1)

        bp_flat = bps.reshape(B, N * (L + 1))
        preds_flat = preds_r.to(i64).reshape(B, N * P)
        lanes = torch.arange(B, device=dev)
        r = best_rank + 1
        j = slen64.clone()
        out = torch.full((B, L), -2, dtype=i32, device=dev)
        # a step of a finished lane changes nothing, so the loop asks
        # whether any lane is still walking only every 64 steps
        steps = 0
        while True:
            active = (r > 0) | (j > 0)
            if steps % 64 == 0 and not bool(active.any()):
                break
            steps += 1
            lin = (r - 1).clamp(0, N - 1) * (L + 1) + j.clamp(0, L)
            code = torch.gather(bp_flat, 1, lin[:, None])[:, 0].to(i64)
            code = torch.where(r > 0, code, 2 * P)
            is_d = code < P
            is_v = (code >= P) & (code < 2 * P)
            p = torch.where(is_d, code, code - P)
            plin = (r - 1).clamp(0, N - 1) * P + p.clamp(0, P - 1)
            pr = torch.gather(preds_flat, 1, plin[:, None])[:, 0]
            consume = active & ~is_v
            jc = (j - 1).clamp(0, L - 1)
            cur = torch.gather(out, 1, jc[:, None])[:, 0]
            emit = torch.where(is_d, r - 1, -1).to(i32)
            out[lanes, jc] = torch.where(consume, emit, cur)
            r = torch.where(active & (is_d | is_v), pr, r)
            j = torch.where(consume, j - 1, j)
        return out

    def one_layer(state, seq, slen, wts, rlo, rhi, band, lidx):
        (codes, preds, predw, nseq, col_of, colkey, colnodes,
         bpos, n_nodes_, n_cols, failed) = state
        dev = codes.device
        B = codes.shape[0]
        active = (slen > 0) & ~failed

        # topological order from the column keys (node-id tiebreak)
        alloc = codes >= 0
        ids = torch.arange(N, dtype=i64, device=dev)[None, :]
        colc = col_of.to(i64).clamp(0, C - 1)
        nkey = torch.where(alloc,
                           (torch.gather(colkey, 1, colc) << 11) | ids,
                           1 << 62)
        order = torch.sort(nkey, dim=1, stable=True).indices
        rank_of = torch.zeros((B, N), dtype=i64, device=dev)
        rank_of.scatter_(1, order, ids.expand(B, N).contiguous())

        # the layer's bpos-range subgraph, by masking
        in_range = (alloc & (bpos >= rlo[:, None]) & (bpos <= rhi[:, None]))
        in_range_r = torch.gather(in_range, 1, order)
        codes_r = torch.gather(codes, 1, order)
        codes_r = torch.where(in_range_r, codes_r,
                              torch.tensor(5, dtype=torch.int8, device=dev))
        pr_nodes = torch.gather(preds, 1,
                                order[:, :, None].expand(B, N, P)).to(i64)
        pr_clip = pr_nodes.clamp(0, N - 1).reshape(B, -1)
        pr_ok = (pr_nodes >= 0) & torch.gather(
            in_range, 1, pr_clip).reshape(B, N, P)
        pr_rank = torch.where(
            pr_ok, torch.gather(rank_of, 1, pr_clip).reshape(B, N, P) + 1,
            -1)
        no_pred = (~pr_ok).all(dim=2) & in_range_r
        pr_rank[:, :, 0] = torch.where(no_pred, 0, pr_rank[:, :, 0])
        kk1 = torch.arange(1, N + 1, dtype=i64, device=dev)[None, :, None]
        ring_fail = ((pr_rank > 0) & (kk1 - pr_rank > RING)).any(dim=2) \
            .any(dim=1)

        has_succ = torch.zeros((B, N + 2), dtype=torch.bool, device=dev)
        succ_pos = torch.where(pr_ok & in_range_r[:, :, None],
                               pr_clip.reshape(B, N, P), N + 1)
        has_succ.scatter_(1, succ_pos.reshape(B, -1),
                          torch.ones((B, N * P), dtype=torch.bool,
                                     device=dev))
        sinks_r = in_range_r & ~torch.gather(has_succ[:, :N], 1, order)

        origin = rlo.to(i32).clamp(min=0)
        centers_r = (torch.gather(bpos, 1, order).to(i32)
                     - origin[:, None] + 1)

        kmax = int(n_nodes_.max()) if B else 0
        band32 = band.to(i32)
        ranks = dp_align(codes_r, pr_rank, sinks_r, centers_r, band32, seq,
                         slen, kmax)

        if not banded_only:
            # the host engine's band_clipped rule: fewer than half the
            # aligned columns matching redoes the lane with the full DP
            node_c = torch.gather(codes_r, 1, ranks.to(i64).clamp(0, N - 1))
            al = ranks >= 0
            n_al = al.sum(dim=1)
            n_ma = (al & (node_c == seq)).sum(dim=1)
            clipped = (active & (band32 > 0)
                       & ((n_al == 0) | (2 * n_ma < n_al)))
            if bool(clipped.any()):
                full = dp_align(codes_r, pr_rank, sinks_r, centers_r,
                                torch.zeros_like(band32), seq, slen, kmax)
                ranks = torch.where(clipped[:, None], full, ranks)

        # ---- ingest
        iidx = torch.arange(L, dtype=i32, device=dev)
        inlen = (iidx[None, :] < slen[:, None]) & active[:, None]
        base = seq.to(i64)
        aligned = (ranks >= 0) & inlen
        rk = ranks.to(i64).clamp(0, N - 1)
        node_at = torch.where(aligned, torch.gather(order, 1, rk), -1)
        nclip = node_at.clamp(0, N - 1)
        col0 = torch.where(aligned,
                           torch.gather(col_of, 1, nclip).to(i64), -1)
        same = aligned & (torch.gather(codes, 1, nclip).to(i64) == base)
        alt = torch.where(
            aligned,
            torch.gather(colnodes.reshape(B, -1), 1,
                         col0.clamp(0, C - 1) * 5 + base.clamp(0, 4)).to(i64),
            -1)
        use_alt = aligned & ~same & (alt >= 0)
        new_in_col = aligned & ~same & (alt < 0)
        insertion = inlen & ~aligned

        akey = torch.where(aligned,
                           torch.gather(colkey, 1, col0.clamp(0, C - 1)), 0)
        abpos = torch.where(aligned,
                            torch.gather(bpos, 1, nclip).to(i64), 0)
        zero = torch.zeros((B, 1), dtype=i64, device=dev)
        pkey = _scan_last(akey, aligned)
        pkey_prev = torch.cat([zero, pkey[:, :-1]], dim=1)
        has_prev = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                          device=dev),
                              torch.cumsum(aligned.to(i32), 1)[:, :-1] > 0],
                             dim=1)
        pbp = _scan_last(abpos, aligned)
        pbp_prev = torch.cat([zero, pbp[:, :-1]], dim=1)
        nkey_next = torch.flip(_scan_last(torch.flip(akey, [1]),
                                          torch.flip(aligned, [1])), [1])
        nbp_next = torch.flip(_scan_last(torch.flip(abpos, [1]),
                                         torch.flip(aligned, [1])), [1])
        any_next = torch.flip(torch.cumsum(torch.flip(aligned, [1]).to(i32),
                                           1) > 0, [1])
        nkey_next = torch.where(any_next, nkey_next, MAXKEY)
        ins_bpos = torch.where(has_prev, pbp_prev, nbp_next).to(torch.int16)

        # position within an insertion run, and the run's length
        ins_i = torch.cumsum(insertion.to(i32), dim=1)
        run_start = _scan_last(ins_i.to(i64), aligned)
        run_start = torch.cat([zero, run_start[:, :-1]], dim=1).to(i32)
        jrun = torch.where(insertion, ins_i - run_start, 0)
        mrun = torch.flip(_scan_seg_max(
            torch.flip(torch.where(insertion, jrun, 0), [1]),
            torch.flip(aligned, [1])), [1])

        # insertion column keys: run-partitioned equal spacing, the low
        # 8 bits the layer's salt
        span = nkey_next - pkey_prev
        m1 = mrun.to(i64) + 1
        spacing = torch.div(span, m1, rounding_mode="floor")
        grid = pkey_prev + torch.div(span * jrun.to(i64), m1,
                                     rounding_mode="floor")
        salt = ((lidx.to(i64) + 1) & 0xFF)[:, None]
        ikey = (grid & ~0xFF) | salt
        key_bad = insertion & ((spacing <= 512) | (ikey <= pkey_prev)
                               | (ikey >= nkey_next))

        new_node = new_in_col | insertion
        nid = (n_nodes_.to(i64)[:, None]
               + torch.cumsum(new_node.to(i64), dim=1) - 1)
        cid = (n_cols.to(i64)[:, None]
               + torch.cumsum(insertion.to(i64), dim=1) - 1)
        overflow = (new_node & (nid >= N)) | (insertion & (cid >= C))
        layer_fail = key_bad.any(dim=1) | overflow.any(dim=1) | ring_fail
        ok = active & ~layer_fail
        okm = ok[:, None]

        target = torch.where(same, node_at,
                             torch.where(use_alt, alt,
                                         torch.where(new_node, nid, -1)))
        tcol = torch.where(insertion, cid, col0)

        def put(arr, pos, val, width):
            # scatter with out-of-range positions dropped (JAX
            # mode="drop"): they land in a spill column cut off after
            ext = torch.cat([arr, arr.new_zeros((B, 2))], dim=1)
            ext.scatter_(1, pos.clamp(max=width + 1), val.to(arr.dtype))
            return ext[:, :width].contiguous()

        sn = torch.where(new_node & okm, nid, N + 1)
        codes = put(codes, sn, base, N)
        col_of = put(col_of, sn, tcol, N)
        tbpos = torch.where(insertion, ins_bpos.to(i64),
                            torch.gather(bpos, 1, nclip).to(i64))
        bpos = put(bpos, sn, tbpos, N)
        sc = torch.where(insertion & okm, cid, C + 1)
        colkey = put(colkey, sc, ikey, C)
        cnpos = torch.where(new_node & okm,
                            tcol.clamp(0, C - 1) * 5 + base, C * 5 + 1)
        colnodes = put(colnodes.reshape(B, C * 5), cnpos, nid,
                       C * 5).reshape(B, C, 5)

        st = torch.where(inlen & (target >= 0) & okm, target, N + 1)
        ext = torch.cat([nseq, nseq.new_zeros((B, 2))], dim=1)
        ext.scatter_add_(1, st, torch.ones_like(st, dtype=nseq.dtype))
        nseq = ext[:, :N].contiguous()

        # edges between consecutive path positions
        tails = target[:, :-1]
        heads = target[:, 1:]
        epresent = inlen[:, 1:] & inlen[:, :-1] & okm
        w32 = wts.to(i32)
        ew = w32[:, :-1] + w32[:, 1:]
        hclip = heads.clamp(0, N - 1)
        hpred = torch.gather(preds, 1,
                             hclip[:, :, None].expand(B, L - 1, P)).to(i64)
        match_slot = (hpred == tails[:, :, None]) & (tails[:, :, None] >= 0)
        empty_slot = hpred < 0
        has_match = match_slot.any(dim=2)
        slot = torch.where(has_match, _first_true(match_slot, 2),
                           _first_true(empty_slot, 2))
        slot_ok = has_match | empty_slot.any(dim=2)
        edge_fail = (epresent & ~slot_ok).any(dim=1)
        failed = failed | (active & (layer_fail | edge_fail))
        eok = epresent & slot_ok & (~edge_fail)[:, None]

        ppos = torch.where(eok, hclip * P + slot, N * P + 1)
        preds = put(preds.reshape(B, N * P), ppos, tails,
                    N * P).reshape(B, N, P)
        ext = torch.cat([predw.reshape(B, N * P),
                         predw.new_zeros((B, 2))], dim=1)
        ext.scatter_add_(1, ppos, ew.to(predw.dtype))
        predw = ext[:, :N * P].reshape(B, N, P).contiguous()
        n_nodes_ = torch.where(ok, n_nodes_ + new_node.sum(dim=1).to(i32),
                               n_nodes_)
        n_cols = torch.where(ok, n_cols + insertion.sum(dim=1).to(i32),
                             n_cols)
        return (codes, preds, predw, nseq, col_of, colkey, colnodes,
                bpos, n_nodes_, n_cols, failed)

    def run(codes, preds, predw, nseq, col_of, colkey, colnodes, bpos,
            n_nodes_, n_cols, failed, seqs, lens, wts, a, b, c, lbase):
        state = (codes, preds, predw, nseq, col_of, colkey, colnodes,
                 bpos, n_nodes_, n_cols, failed)
        for d in range(D):
            lidx = lbase.to(i32) + d
            slen = lens[:, d].to(i32)
            if device_slice:
                rlo, rhi, band = slice_layer(a[:, d], b[:, d], slen,
                                             c[0], c[1])
            else:
                rlo, rhi, band = a[:, d], b[:, d], c[:, d]
            state = one_layer(state, seqs[:, d], slen, wts[:, d], rlo, rhi,
                              band, lidx)
        return state

    if device_slice:
        def run_sliced(codes, preds, predw, nseq, col_of, colkey, colnodes,
                       bpos, n_nodes_, n_cols, failed, seqs, lens, wts,
                       begins, ends, bblen, offs, lbase):
            return run(codes, preds, predw, nseq, col_of, colkey, colnodes,
                       bpos, n_nodes_, n_cols, failed, seqs, lens, wts,
                       begins, ends, (bblen, offs), lbase)
        return run_sliced
    return run


def slice_layer(begins, ends, slen, bblen, offs):
    """The host packer's window slicing as integer arithmetic on one
    layer's [B] coordinates: the spanning rule (reference
    window.cpp:97-102, `offs` = int(0.01 * backbone length)), the bpos
    range and the static-band rule. Returns (rlo, rhi) int16, band int32."""
    b32 = begins.to(torch.int32)
    e32 = ends.to(torch.int32)
    bb32 = bblen.to(torch.int32)
    of32 = offs.to(torch.int32)
    spanning = (b32 < of32) & (e32 > bb32 - of32)
    span = torch.where(spanning, bb32, e32 - b32 + 1)
    rlo = torch.where(spanning, -32768, b32).to(torch.int16)
    rhi = torch.where(spanning, 32767, e32).to(torch.int16)
    band = torch.where((slen - span).abs() < 256 // 2 - 16, 256, 0) \
        .to(torch.int32)
    return rlo, rhi, band


def _pinned_rows(dev: torch.device, n_nodes: int, seq_len: int,
                 max_pred: int) -> int:
    """One pinned batch width per envelope from the device budget (the
    90%-of-free rule of cudapolisher.cpp:169-173), priced per row as the
    JAX package prices it: the DP carry, the backpointers and the graph
    arrays. /3 keeps two pipelined chunks in flight with slack."""
    h = (n_nodes + 1) * (seq_len + 1) * 4
    bps = n_nodes * (seq_len + 1)
    state = n_nodes * (2 * max_pred * 3 + 30)
    return pin_pow2_rows(device_budget(dev) // 3, h + bps + state)


def _weights_of(qual, length):
    if qual:
        w = np.frombuffer(qual, np.uint8).astype(np.int32) - 33
        return np.clip(w, 0, 127)  # Phred <= 93; int8-safe by contract
    return np.ones(length, dtype=np.int32)


class FusedPOA:
    """Whole-window device POA engine (see module docstring).

    consensus(windows) has the session engine's contract: windows are
    lists of (seq, qual|None, begin, end) with element 0 the backbone;
    returns (results, statuses) with statuses 0 = built on the device,
    1 = left to the caller / host-built, 2 = backbone-only.

    `fused` is the chunk posture: '1' one launch per chunk (slicing on
    the device) whenever the chunk's chain fits FUSED_LOOP_MAX_DEPTH, '0'
    one launch per chained call (slicing on the host), 'auto' the winner
    of `autotuner`'s table for the chunk's leading depth bucket (engine
    "fused_loop", key (N, L, plan[0]), params (match, mismatch, gap, P)),
    split where the table has none. `score_dtype` is the posture of
    ops/dtypes (int16 where the proof holds at this engine's (N, L) and
    scores; under `auto` the table's "fused" entry at (N, L) may keep
    int32).
    """

    def __init__(self, match: int, mismatch: int, gap: int,
                 device: str | torch.device = "cuda", num_threads: int = 1,
                 logger: Logger | None = None, max_nodes: int = MAX_NODES,
                 max_len: int = MAX_LEN, max_pred: int = MAX_PRED,
                 batch_rows: int | None = None,
                 depth_buckets=DEPTH_BUCKETS, banded_only: bool = False,
                 fused: str = "auto", score_dtype: str = "auto",
                 scheduler=None, runner=None, autotuner=None):
        from ..parallel.mesh import BatchRunner
        from ..sched import BatchScheduler

        if fused not in ("auto", "0", "1"):
            raise ValueError(f"fused posture {fused!r}: want 'auto', '0' "
                             f"or '1'")
        self.device = resolve(device)
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.num_threads = num_threads
        self.logger = logger
        self.N = max_nodes
        self.L = max_len
        self.P = max_pred
        #: occupancy-aware scheduler (sched/): adaptive depth ladder when
        #: armed, per-depth-bucket occupancy telemetry always
        self.sched = (scheduler if scheduler is not None
                      else BatchScheduler())
        #: the lanes each chunk is split over (one lane on `device` when
        #: omitted). B is sized PER LANE from the device budget, times
        #: the lane count, as the JAX engine sizes it per device; a
        #: forced width is rounded up to a multiple of the lanes
        self.runner = (runner if runner is not None
                       else BatchRunner([self.device]))
        if batch_rows:
            self.B = self.runner.round_batch(batch_rows)
        else:
            self.B = (_pinned_rows(self.runner.devices[0], self.N, self.L,
                                   self.P) * self.runner.n_devices)
        self.depth_buckets = tuple(depth_buckets)
        #: the adaptive depth ladder's launch-shape budget, pinned to the
        #: construction-time ladder size so adapt() is idempotent
        self._depth_k = len(self.depth_buckets)
        self.banded_only = banded_only
        self.fused_posture = fused
        self.autotuner = autotuner
        #: one launch a chunk or not, per leading depth bucket (posture
        #: auto), resolved once
        self._fused_plans: dict[int, bool] = {}
        self.score_dtype = kernel_plan(
            score_dtype, autotuner, "fused", (self.N, self.L),
            (match, mismatch, gap, self.P),
            poa_int16_ok(self.N, self.L, match, mismatch, gap),
            self.device.type)
        self._code_of = np.full(256, 4, dtype=np.int8)
        for i, b in enumerate(b"ACGT"):
            self._code_of[b] = i
        self.last_stats: dict = {}
        self.n_fallback = 0
        # CUDA streams, kept for the engine's life, and K3 scratch, one per
        # stream that launches K3 (a pipeline stream, or a lane's), kept
        # for a consensus pass
        self._streams: list = []
        self._scratch: dict = {}

    def _stream_pool(self, n: int):
        """The engine's first n CUDA streams (created once, kept for the
        run), or None on the CPU."""
        if self.device.type != "cuda":
            return None
        while len(self._streams) < n:
            self._streams.append(torch.cuda.Stream(self.device))
        return self._streams[:n]

    def _scratch_of(self, dev: torch.device, rows: int):
        """K3's scratch for the current stream of `dev` (the stream that
        launches), `rows` rows, allocated at its first use in a consensus
        pass (on that stream) and kept until the pass ends; None on the
        CPU."""
        from .poa_fused_kernels import scratch

        if dev.type != "cuda":
            return None
        st = torch.cuda.current_stream(dev)
        key = (dev.index, st.cuda_stream, rows)
        if key not in self._scratch:
            self._scratch[key] = scratch(rows, self.N, self.L, dev,
                                         self.score_dtype)
        return self._scratch[key]

    def _fused_plan(self, plan) -> bool:
        """One fused launch for a chunk whose chain plan is `plan`? Never
        beyond FUSED_LOOP_MAX_DEPTH nor under posture '0', always under
        '1'; under 'auto' where the winner table's "fused_loop" entry for
        the chunk's leading (largest) chain bucket says `fused`."""
        if not plan or sum(plan) > FUSED_LOOP_MAX_DEPTH:
            return False
        if self.fused_posture != "auto":
            return self.fused_posture == "1"
        key = plan[0]
        cached = self._fused_plans.get(key)
        if cached is None:
            ent = (self.autotuner.winner(
                "fused_loop", (self.N, self.L, key),
                (self.match, self.mismatch, self.gap, self.P),
                backend=self.device.type)
                if self.autotuner is not None else None)
            cached = self._fused_plans[key] = (
                (ent or {}).get("kernel") == "fused")
        return cached

    def _eligible(self, win) -> bool:
        bb_len = len(win[0][0])
        if bb_len + 1 > self.N:
            return False
        for seq, _, b, e in win[1:]:
            if not seq or len(seq) > self.L:
                return False
        return True

    def _fused_order(self, windows) -> list[int]:
        """Eligible window indices, deepest first."""
        idx = [i for i, w in enumerate(windows)
               if len(w) >= 3 and self._eligible(w)]
        idx.sort(key=lambda i: -len(windows[i]))
        return idx

    def _adapt_depths(self, windows, fused_idx) -> None:
        """Adaptive depth ladder from the ACTUAL chunk-max depths — known
        exactly once windows are depth-sorted, since chunks are carved
        from that list in B-strides; every padded layer costs B * L
        device work, so tight edges are the whole occupancy story.
        No-op when the scheduler is off."""
        if not self.sched.adaptive or not fused_idx:
            return
        maxima = [len(windows[fused_idx[s]]) - 1
                  for s in range(0, len(fused_idx), self.B)]
        ladder = self.sched.depth_ladder(maxima, k=self._depth_k)
        if ladder:
            self.depth_buckets = ladder

    def adapt(self, windows) -> None:
        """Derive the adaptive depth ladder ahead of consensus() (the
        ladder is a pure function of the window set; consensus() derives
        the same one)."""
        self._adapt_depths(windows, self._fused_order(windows))

    def _chain_plan(self, depth: int) -> list[int]:
        """The greedy chained-call depth sequence for one chunk depth."""
        plan, done = [], 0
        while done < depth:
            rem = depth - done
            fits = [b for b in self.depth_buckets if b <= rem]
            d = max(fits) if fits else min(
                b for b in self.depth_buckets if b >= rem)
            plan.append(d)
            done += d
        return plan

    def _init_state(self, backbones, bweights):
        B, N, P, C = self.B, self.N, self.P, self.N
        codes = np.full((B, N), -1, dtype=np.int8)
        preds = np.full((B, N, P), -1, dtype=np.int16)
        predw = np.zeros((B, N, P), dtype=np.int32)
        nseq = np.zeros((B, N), dtype=np.int32)
        col_of = np.full((B, N), -1, dtype=np.int16)
        colkey = np.zeros((B, C), dtype=np.int64)
        colnodes = np.full((B, C, 5), -1, dtype=np.int16)
        bpos = np.zeros((B, N), dtype=np.int16)
        n_nodes = np.zeros(B, dtype=np.int32)
        n_cols = np.zeros(B, dtype=np.int32)
        failed = np.zeros(B, dtype=bool)
        for k, (bb, w) in enumerate(zip(backbones, bweights)):
            m = len(bb)
            codes[k, :m] = self._code_of[np.frombuffer(bb, np.uint8)]
            col_of[k, :m] = np.arange(m)
            colkey[k, :m] = (np.arange(m, dtype=np.int64) + 1) << 32
            colnodes[k, np.arange(m), codes[k, :m]] = np.arange(m)
            bpos[k, :m] = np.arange(m)
            preds[k, 1:m, 0] = np.arange(m - 1)
            predw[k, 1:m, 0] = w[:-1] + w[1:]
            nseq[k, :m] = 1
            n_nodes[k] = m
            n_cols[k] = m
        return (codes, preds, predw, nseq, col_of, colkey,
                colnodes, bpos, n_nodes, n_cols, failed)

    def _pack_chunk(self, windows, chunk):
        """Host packing for one chunk on the split posture: the initial
        state plus every chained call's padded layer operands, sliced on
        the host. Returns (state, [(depth bucket, (seqs, lens, wts, rlo,
        rhi, band), layer base), ...])."""
        backbones = [windows[i][0][0] for i in chunk]
        bweights = [_weights_of(windows[i][0][1], len(windows[i][0][0]))
                    for i in chunk]
        state = self._init_state(backbones, bweights)
        depth = max(len(windows[i]) - 1 for i in chunk)
        done = 0
        # layer order: a stable sort by begin, the host engine's visit
        # order (reference window.cpp:84-85)
        metas = [(sorted(windows[i][1:], key=lambda s: s[2]),
                  len(windows[i][0][0])) for i in chunk]
        calls = []
        for d in self._chain_plan(depth):
            seqs = np.full((self.B, d, self.L), 5, np.int8)
            lens = np.zeros((self.B, d), np.int32)
            wts = np.zeros((self.B, d, self.L), np.int8)
            rlo = np.full((self.B, d), -32768, np.int16)
            rhi = np.full((self.B, d), 32767, np.int16)
            band = np.zeros((self.B, d), np.int32)
            for k, (layers, bb_len) in enumerate(metas):
                offset = int(0.01 * bb_len)
                for dd in range(d):
                    li = done + dd
                    if li >= len(layers):
                        break
                    seq, qual, b, e = layers[li]
                    seqs[k, dd, :len(seq)] = self._code_of[
                        np.frombuffer(seq, np.uint8)]
                    lens[k, dd] = len(seq)
                    wts[k, dd, :len(seq)] = _weights_of(qual, len(seq))
                    spanning = b < offset and e > bb_len - offset
                    span = bb_len if spanning else e - b + 1
                    if not spanning:
                        # the bpos-range subgraph (window.cpp:97-102)
                        rlo[k, dd] = b
                        rhi[k, dd] = e
                    # the host engine's static-band rule
                    if abs(len(seq) - span) < 256 // 2 - 16:
                        band[k, dd] = 256
            calls.append((d, (seqs, lens, wts, rlo, rhi, band), done))
            done += d
        return state, calls

    def _pack_chunk_fused(self, windows, chunk, D: int):
        """Host packing for one chunk on the fused posture: the initial
        state plus one operand set over the whole chain depth D, with the
        raw (begin, end) coordinates and the per-row backbone length and
        spanning offset (the slicing runs on the device)."""
        backbones = [windows[i][0][0] for i in chunk]
        bweights = [_weights_of(windows[i][0][1], len(windows[i][0][0]))
                    for i in chunk]
        state = self._init_state(backbones, bweights)
        seqs = np.full((self.B, D, self.L), 5, np.int8)
        lens = np.zeros((self.B, D), np.int32)
        wts = np.zeros((self.B, D, self.L), np.int8)
        begins = np.zeros((self.B, D), np.int32)
        ends = np.zeros((self.B, D), np.int32)
        bblen = np.zeros(self.B, np.int32)
        offs = np.zeros(self.B, np.int32)
        for k, i in enumerate(chunk):
            layers = sorted(windows[i][1:], key=lambda s: s[2])
            bb_len = len(windows[i][0][0])
            bblen[k] = bb_len
            # float truncation kept bit-exact with the split packer
            offs[k] = int(0.01 * bb_len)
            for dd, (seq, qual, b, e) in enumerate(layers[:D]):
                seqs[k, dd, :len(seq)] = self._code_of[
                    np.frombuffer(seq, np.uint8)]
                lens[k, dd] = len(seq)
                wts[k, dd, :len(seq)] = _weights_of(qual, len(seq))
                begins[k, dd] = b
                ends[k, dd] = e
        return state, (seqs, lens, wts, begins, ends, bblen, offs)

    def _pack_calls(self, windows, chunk, plan, fused: bool,
                    lanes: int = 1):
        """A chunk's initial state and its calls as tensors (`_to_device`):
        one call over the whole chain `plan` when `fused`, else the split
        posture's chained calls; each call (depth, operands, layer base),
        its operands ending in the per-row layer base."""
        if fused:
            state, ops = self._pack_chunk_fused(windows, chunk, sum(plan))
            calls = [(sum(plan), ops, 0)]
        else:
            state, calls = self._pack_chunk(windows, chunk)
        return self._to_device(state, lanes), [
            (d, self._to_device(ops + (np.full(self.B, done, np.int32),),
                                lanes), done)
            for d, ops, done in calls]

    def pack_run(self, windows, chunk, fused: bool):
        """One chunk (at most B eligible windows) packed for a run
        outside the dispatch pipeline, as consensus() packs it: (initial
        state, calls), one call over the whole chain when `fused`, else
        the split posture's chained calls. The autotuner's K3 profile
        packs each posture once and times `run_packed` alone."""
        plan = self._chain_plan(max(len(windows[i]) - 1 for i in chunk))
        state, calls = self._pack_calls(windows, chunk, plan, fused)
        return tuple(state), calls

    def run_packed(self, state, calls):
        """A packed chunk's calls through K3 (its plain version on the
        CPU) on the current stream. Returns the final state; on a card
        the kernel updates `state` in place, so run a copy to run the
        chunk again."""
        from .poa_fused_kernels import fused_layers

        scratch = self._scratch_of(self.device, self.B)
        for _, (seqs, lens, wts, *slicing, lbase), _ in calls:
            state = fused_layers(
                state, seqs, lens, wts, tuple(slicing), lbase, self.match,
                self.mismatch, self.gap, banded_only=self.banded_only,
                score_dtype=self.score_dtype, scratch=scratch)
        return state

    def finalize_run(self, windows, chunk, state):
        """(results, statuses) over `windows` from a run's final state,
        as consensus() finalizes a chunk: (None, 1) for a window outside
        the chunk or failed on the device."""
        results: list = [None] * len(windows)
        statuses = np.ones(len(windows), dtype=np.int32)
        self._finalize_chunk(chunk, tuple(t.cpu().numpy() for t in state),
                             results, statuses)
        return results, statuses

    def _to_device(self, arrays, lanes: int = 1):
        """Host arrays as tensors on the engine's device (one lane:
        copied asynchronously from pinned memory on the current stream),
        or left pinned on the host for the runner to place per lane."""
        from ..parallel.mesh import BatchRunner

        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory()
                if lanes == 1:
                    t = BatchRunner.place(t, self.device)
            out.append(t)
        return out

    def consensus(self, windows, fallback: bool = True, pipeline=None):
        """Build every eligible window's graph on the device, deepest
        first, in chunks of B. fallback=False leaves the windows the
        engine does not build as (None, status 1) for the caller (the
        session engine, by default); fallback=True polishes them with the
        host engine, the ineligible ones on the pipeline's fallback pool
        while the device pass runs.

        `pipeline` (pipeline.DispatchPipeline) drives the chunk loop:
        `pack` builds a chunk's operands on the host and (one lane)
        starts their copies to the card, `dispatch` launches K3 (once per
        chained call, or once on the fused posture) on each of the
        runner's lanes and the copies of the state back, `wait` blocks on
        the chunk's event, `unpack` runs the host heaviest-bundle. On a
        card each chunk in flight runs on its own CUDA stream, from the
        engine's pool of depth + 2 (kept for the engine's life); with
        several lanes each lane's shard runs on its lane's stream. Each
        stream that launches K3 has its own K3 scratch (kept for the
        pass: freed at its end, its blocks stay cached on the stream for
        the next pass). Omitted, the stages run synchronously (depth 0).
        A device error raises.

        The adaptive scheduler derives the depth ladder from the chunks'
        deepest windows first; every chained call (or fused chunk) is
        recorded in layer units, a window counting as a job on its
        chunk's first call only.
        """
        from ..native import poa_batch
        from ..pipeline import DispatchPipeline
        from .poa_fused_kernels import fused_layers

        n = len(windows)
        results: list = [None] * n
        statuses = np.ones(n, dtype=np.int32)
        for i, w in enumerate(windows):
            if len(w) < 3:
                statuses[i] = 2
                results[i] = (w[0][0], np.zeros(len(w[0][0]), np.uint32))
        fused_idx = self._fused_order(windows)
        fused_set = set(fused_idx)
        self._adapt_depths(windows, fused_idx)

        bar = self.logger.bar if self.logger is not None else None
        if self.logger is not None and fused_idx:
            self.logger.bar_total(len(fused_idx))
        self.last_stats = stats = {"chunks": 0, "launches": 0,
                                   "pack_s": 0.0, "device_s": 0.0,
                                   "unpack_s": 0.0, "fused_chunks": 0}
        own_pipeline = pipeline is None
        pl = pipeline if pipeline is not None else DispatchPipeline(depth=0)

        # the windows the engine cannot take are known now: polish them
        # on the fallback pool while the device pass runs
        prefall: list = []
        if fallback and pl.depth > 0:
            ineligible = [i for i in range(n)
                          if statuses[i] == 1 and i not in fused_set]
            fb_threads = max(1, self.num_threads // pl.fallback_workers)
            prefall = pl.map_fallback(
                ineligible,
                lambda sub: poa_batch([windows[i] for i in sub],
                                      self.match, self.mismatch, self.gap,
                                      n_threads=fb_threads))

        streams = self._stream_pool(pl.depth + 2)
        n_dev = self.runner.n_devices
        kernel = "cuda" if self.device.type == "cuda" else "plain"

        def on_stream(k):
            if streams is None:
                return contextlib.nullcontext()
            return torch.cuda.stream(streams[k % len(streams)])

        def pack(item):
            k, chunk = item
            plan = self._chain_plan(max(len(windows[i]) - 1 for i in chunk))
            fused = self._fused_plan(plan)
            with trace.span("fused.pack"), on_stream(k):
                state, calls = self._pack_calls(windows, chunk, plan, fused,
                                                n_dev)
            return fused, state, calls

        def lane(calls, *tensors):
            """One lane's shard of a chunk: every chained call (or the
            one fused launch) against the shard's state, with the
            stream's own K3 scratch; each call's first dispatch timed
            for the first-dispatch telemetry."""
            import time

            state = tuple(tensors[:len(STATE)])
            rest = tensors[len(STATE):]
            rows = state[0].shape[0]
            scratch = self._scratch_of(state[0].device, rows)
            for d, n_ops, _, key in calls:
                seqs, lens, wts, *slicing, lbase = rest[:n_ops]
                rest = rest[n_ops:]
                t0 = time.perf_counter()
                state = fused_layers(
                    state, seqs, lens, wts, tuple(slicing), lbase,
                    self.match, self.mismatch, self.gap,
                    banded_only=self.banded_only,
                    score_dtype=self.score_dtype, scratch=scratch)
                self.sched.stats.record_compile_once(
                    "fused", key, time.perf_counter() - t0)
            return state

        def dispatch(item, packed):
            from ..parallel.mesh import concat
            from .device_program import shard_useful_split

            k, chunk = item
            fused, state, calls = packed
            depths = [len(windows[i]) - 1 for i in chunk]
            # per chained call: its depth, operand count, layer base and
            # launch identity (the JAX engine's first-compile key)
            spec = [(d, len(ops), done,
                     (self.N, self.L, d, self.P, self.match, self.mismatch,
                      self.gap, self.banded_only, self.B, n_dev > 1,
                      self.score_dtype, kernel) + (("loop",) if fused
                                                   else ()))
                    for d, ops, done in calls]
            with trace.span("fused.kernel"), on_stream(k), \
                    trace.span("fused.dispatch", engine="fused",
                               jobs=len(chunk), calls=len(calls)):
                outs = self.runner.run_split(
                    functools.partial(lane, spec), *state,
                    *(t for _, ops, _ in calls for t in ops))
                state = concat(outs, self.device)
                # occupancy in LAYER units, after the launches: every row
                # pays all d layer steps of each call, real or padded; a
                # window counts as a job on its chunk's first call only
                for d, _, done, _ in spec:
                    row_layers = [min(max(0, dep - done), d)
                                  for dep in depths]
                    self.sched.stats.record(
                        "fused", d, jobs=len(chunk) if done == 0 else 0,
                        lanes=self.B, useful_cells=sum(row_layers),
                        total_cells=self.B * d, kernel=kernel,
                        dtype=self.score_dtype, n_devices=n_dev,
                        shard_useful=shard_useful_split(row_layers, self.B,
                                                        n_dev),
                        full_mesh_cells=self.B * d)
                pl.stats.bump("launches", len(calls))
                stats["fused_chunks"] += fused
                if streams is None:
                    return state, None
                # the copies back, queued behind the kernel on the
                # chunk's stream, into pinned buffers
                host = []
                for t in state:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    host.append(h)
                done_ev = torch.cuda.Event()
                done_ev.record()
            return host, done_ev

        def wait(handle):
            state, done_ev = handle
            if done_ev is not None:
                done_ev.synchronize()
            return tuple(t.numpy() for t in state)

        def unpack(item, np_state):
            _, chunk = item
            with trace.span("fused.finish"):
                self._finalize_chunk(chunk, np_state, results, statuses)
            if bar is not None:
                for _ in chunk:
                    bar("[racon_tpu_torch::Polisher.polish] building "
                        "whole-window POA graphs on device")

        # lane balance: within each FULL chunk, windows round-robin over
        # the lanes' row shards, so the depth-sorted deep windows spread
        # over the lanes instead of loading the first; a pure
        # permutation (per-window results are row-independent). The tail
        # chunk keeps sorted order: its rows run contiguous from row 0.
        from ..sched import shard_interleave

        chunks = [shard_interleave(c, n_dev) if len(c) == self.B else c
                  for c in (fused_idx[s:s + self.B]
                            for s in range(0, len(fused_idx), self.B))]
        try:
            base = pl.stats.snapshot()
            pl.run(list(enumerate(chunks)), pack, dispatch, wait, unpack,
                   label="fused",
                   describe=lambda c: {"engine": "fused",
                                       "jobs": len(c[1])})
            after = pl.stats.snapshot()
            for key in ("pack_s", "device_s", "unpack_s", "chunks",
                        "launches"):
                stats[key] = after[key] - base[key]
            pl.drain_fallback()
            for sub, fut in prefall:
                for i, r in zip(sub, fut.result()):
                    results[i] = r
                    statuses[i] = 1
        finally:
            self._scratch.clear()
            if own_pipeline:
                pl.close()

        # everything left is ineligible (depth 0) or failed on the device
        rest = [i for i in range(n) if results[i] is None]
        self.n_fallback = len(rest) + sum(len(s) for s, _ in prefall)
        if rest and fallback:
            host = poa_batch([windows[i] for i in rest], self.match,
                             self.mismatch, self.gap,
                             n_threads=self.num_threads)
            for i, r in zip(rest, host):
                results[i] = r
                statuses[i] = 1
        return results, statuses

    def _finalize_chunk(self, chunk, state, results, statuses):
        from ..native import poa_finish_arrays

        (codes, preds, predw, nseq, col_of, colkey, colnodes,
         bpos, n_nodes, n_cols, failed) = (np.asarray(x) for x in state)
        okrows = [k for k in range(len(chunk)) if not failed[k]]
        if okrows:
            sel = np.asarray(okrows)
            fin = poa_finish_arrays(
                codes[sel], preds[sel], predw[sel], nseq[sel],
                col_of[sel], colkey[sel], n_nodes[sel],
                n_threads=self.num_threads)
            for k, r in zip(okrows, fin):
                results[chunk[k]] = r
                statuses[chunk[k]] = 0
