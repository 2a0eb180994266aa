"""Progressive (SOF2) entropy decode: multi-scan -> DCT coefficients.

A progressive stream distributes each block's 64 coefficients over many
scans: spectral selection splits the zigzag band (Ss..Se), successive
approximation splits bit-planes (Ah/Al). Decode therefore *accumulates*
into a per-component coefficient store across scans — DC first scans
seed ``pred << Al``, DC refinements OR in one bit, AC first scans place
``extend(v) << Al`` with EOB run-length coding (EOBn symbols skip whole
blocks), and AC refinements append correction bits to already-nonzero
coefficients (F.2.4.3).

The accumulation invariant: scans over disjoint (component, band,
bit-plane) regions commute — any legal ordering of such scans produces
the same coefficient store — while refinement scans are serial in their
own band (each consumes the previous scan's Al as its Ah). The T.81
progression rules encode exactly that partial order; ``_check_script``
enforces it and raises typed ``CorruptJpeg`` on malformed scan scripts.

Output is the same natural-order ``{cid: int32 [by, bx, 8, 8]}``
MCU-padded layout baseline ``decode_coefficients`` produces, so the
dequant+IDCT pipeline (numpy, jnp, Pallas, batched) consumes it
unchanged. Entropy decode stays bit-serial per scan on the host — scan
loops never enter jit-traced bodies (the ``repro.analysis`` jit rules
pin this).

Scope notes vs baseline decode:
- Interleaved scans (DC only, per T.81) walk the MCU grid and touch the
  full MCU-padded block grid; non-interleaved scans walk the component's
  *own* ceil-dims block grid (A.2.2) — padding blocks beyond it keep
  zero AC, which is invisible after the spatial crop.
- Restart intervals apply per scan (DRI may change between scans) and
  count MCUs (interleaved) or blocks (non-interleaved); DC predictors
  and the EOB run reset at every boundary.
- Interval-parallel decode does not apply: coefficient state crosses
  scans, so a parallel-worker request is demoted to serial and recorded
  (``fallback_progressive_scan``) like every other fallback.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.jpeg import huffman as H
from repro_torch.jpeg import tables as T
from repro_torch.jpeg.parser import Component, CorruptJpeg, DecodeSpec, Scan
from repro_torch.obs import trace


def _check_script(spec: DecodeSpec) -> None:
    """Validate the scan sequence against the T.81 progression rules,
    tracking per-coefficient bit positions the way libjpeg's
    ``coef_bits`` does. Violations are malformed scan scripts -> typed
    ``CorruptJpeg`` naming the scan and the rule."""
    coef_bits = {c.cid: [-1] * 64 for c in spec.components}
    for idx, sc in enumerate(spec.scans):
        ss, se, ah, al = sc.ss, sc.se, sc.ah, sc.al
        if not sc.comps:
            raise CorruptJpeg(f"scan {idx}: no components")
        if not (0 <= ss <= 63 and ss <= se <= 63):
            raise CorruptJpeg(
                f"scan {idx}: invalid spectral band Ss={ss} Se={se}")
        if ss == 0 and se != 0:
            raise CorruptJpeg(
                f"scan {idx}: progressive scan mixes DC and AC "
                f"(Ss=0 Se={se})")
        if ss > 0 and len(sc.comps) != 1:
            raise CorruptJpeg(
                f"scan {idx}: AC scan must be non-interleaved "
                f"({len(sc.comps)} components)")
        if not (0 <= al <= 13 and 0 <= ah <= 13):
            raise CorruptJpeg(
                f"scan {idx}: successive approximation out of range "
                f"Ah={ah} Al={al}")
        if ah != 0 and ah != al + 1:
            raise CorruptJpeg(
                f"scan {idx}: refinement must shift one bit "
                f"(Ah={ah} Al={al})")
        for cid, _, _ in sc.comps:
            if cid not in coef_bits:
                raise CorruptJpeg(f"scan {idx}: unknown component {cid}")
            bits = coef_bits[cid]
            if ss > 0 and bits[0] < 0:
                raise CorruptJpeg(
                    f"scan {idx}: AC scan before first DC scan for "
                    f"component {cid}")
            for k in range(ss, se + 1):
                if ah == 0:
                    if bits[k] >= 0:
                        raise CorruptJpeg(
                            f"scan {idx}: coefficient {k} of component "
                            f"{cid} sent twice as a first scan")
                elif bits[k] != ah:
                    raise CorruptJpeg(
                        f"scan {idx}: refinement of coefficient {k} of "
                        f"component {cid} expects prior Al={ah}, "
                        f"have {bits[k]}")
                bits[k] = al


def _lut(luts: dict, tc: int, th: int):
    try:
        return luts[(tc, th)]
    except KeyError:
        raise CorruptJpeg(
            f"scan references undefined huffman table "
            f"({'DC' if tc == 0 else 'AC'} id {th})") from None


# --------------------------------------------------------- per-block decode
def _dc_first(br: H.BitReader, dc_sym, dc_len, pred: int) -> int:
    w = br.peek16()
    s = int(dc_sym[w])
    if s < 0:
        raise CorruptJpeg("bad DC code in progressive scan")
    br.drop(int(dc_len[w]))
    return pred + H._extend(br.get(s), s)


def _ac_first_block(br: H.BitReader, blk_zz: np.ndarray, ss: int, se: int,
                    al: int, ac_sym, ac_len, eobrun: int) -> int:
    """F.2.2.2-style run decode of one block's band; ``blk_zz`` is the
    zigzag-order 64-vector. Returns the remaining EOB run."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        w = br.peek16()
        rs = int(ac_sym[w])
        if rs < 0:
            raise CorruptJpeg("bad AC code in progressive scan")
        br.drop(int(ac_len[w]))
        r, s = rs >> 4, rs & 0xF
        if s == 0:
            if r == 15:          # ZRL
                k += 16
                continue
            eobrun = (1 << r) - 1    # EOBn: this block ends here
            if r:
                eobrun += br.get(r)
            break
        k += r
        if k > se:
            raise CorruptJpeg("AC run overflows spectral band")
        blk_zz[k] = H._extend(br.get(s), s) << al
        k += 1
    return eobrun


def _ac_refine_block(br: H.BitReader, blk_zz: np.ndarray, ss: int, se: int,
                     al: int, ac_sym, ac_len, eobrun: int) -> int:
    """Successive-approximation AC refinement (F.2.4.3, the jdphuff
    algorithm): newly-nonzero coefficients arrive as +-1 at bit ``al``;
    every already-nonzero coefficient crossed — including the EOB-run
    tail — consumes one correction bit."""
    p1 = 1 << al
    m1 = -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            w = br.peek16()
            rs = int(ac_sym[w])
            if rs < 0:
                raise CorruptJpeg("bad AC code in progressive scan")
            br.drop(int(ac_len[w]))
            r, s = rs >> 4, rs & 0xF
            if s == 0:
                if r != 15:      # EOBn: current block is run member #1 —
                    eobrun = 1 << r      # its band tail still consumes
                    if r:                # correction bits below
                        eobrun += br.get(r)
                    break
                newval = 0       # ZRL: skip 16 zero-history positions
            elif s == 1:
                newval = p1 if br.get(1) else m1
            else:
                raise CorruptJpeg(
                    "AC refinement magnitude must be 1")
            # advance over r zero-history coefficients, applying
            # correction bits to nonzero-history ones crossed on the way
            while k <= se:
                c = int(blk_zz[k])
                if c:
                    if br.get(1) and (c & p1) == 0:
                        blk_zz[k] = c + (p1 if c >= 0 else m1)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if newval:
                if k > se:
                    raise CorruptJpeg(
                        "AC refinement run overflows spectral band")
                blk_zz[k] = newval
            k += 1
    if eobrun > 0:
        while k <= se:           # EOB-run tail: correction bits only
            c = int(blk_zz[k])
            if c and br.get(1) and (c & p1) == 0:
                blk_zz[k] = c + (p1 if c >= 0 else m1)
            k += 1
        eobrun -= 1
    return eobrun


# ------------------------------------------------------------- scan decode
def _decode_dc_segment(br: H.BitReader, sc: Scan,
                       comps: Dict[int, Component],
                       acc: Dict[int, np.ndarray], mcu_cols: int,
                       cdims: Dict[int, Tuple[int, int]], luts: dict,
                       u0: int, cnt: int) -> None:
    ah, al = sc.ah, sc.al
    preds = {cid: 0 for cid, _, _ in sc.comps}
    if len(sc.comps) > 1:        # interleaved: MCU order, padded grid
        for u in range(u0, u0 + cnt):
            my, mx = divmod(u, mcu_cols)
            for cid, td, _ in sc.comps:
                c = comps[cid]
                grid = acc[cid]
                dc_sym, dc_len = _lut(luts, 0, td) if ah == 0 else (None,
                                                                    None)
                for dy in range(c.v):
                    for dx in range(c.h):
                        row = grid[my * c.v + dy, mx * c.h + dx]
                        if ah == 0:
                            preds[cid] = _dc_first(br, dc_sym, dc_len,
                                                   preds[cid])
                            row[0] = preds[cid] << al
                        elif br.get(1):
                            row[0] |= 1 << al
    else:                        # single component: its own block raster
        cid, td, _ = sc.comps[0]
        grid = acc[cid]
        _, cx = cdims[cid]
        dc_sym, dc_len = _lut(luts, 0, td) if ah == 0 else (None, None)
        for u in range(u0, u0 + cnt):
            by, bx = divmod(u, cx)
            row = grid[by, bx]
            if ah == 0:
                preds[cid] = _dc_first(br, dc_sym, dc_len, preds[cid])
                row[0] = preds[cid] << al
            elif br.get(1):
                row[0] |= 1 << al


def _decode_ac_segment(br: H.BitReader, sc: Scan,
                       acc: Dict[int, np.ndarray],
                       cdims: Dict[int, Tuple[int, int]], luts: dict,
                       u0: int, cnt: int) -> None:
    cid, _, ta = sc.comps[0]
    grid = acc[cid]
    _, cx = cdims[cid]
    ac_sym, ac_len = _lut(luts, 1, ta)
    block_fn = _ac_first_block if sc.ah == 0 else _ac_refine_block
    eobrun = 0
    for u in range(u0, u0 + cnt):
        by, bx = divmod(u, cx)
        eobrun = block_fn(br, grid[by, bx], sc.ss, sc.se, sc.al,
                          ac_sym, ac_len, eobrun)


def _decode_scan(sc: Scan, comps: Dict[int, Component],
                 acc: Dict[int, np.ndarray], mcu_rows: int, mcu_cols: int,
                 cdims: Dict[int, Tuple[int, int]]) -> None:
    luts = H._luts_for(H.hashable_tables(sc.htables))
    if len(sc.comps) > 1:
        units = mcu_rows * mcu_cols      # interleaved: MCUs
    else:
        cy, cx = cdims[sc.comps[0][0]]
        units = cy * cx                  # non-interleaved: blocks
    ri = sc.restart_interval
    if ri:
        expected = (units + ri - 1) // ri
        segs = H._restart_segments(sc.data)
        if len(segs) < expected:
            raise CorruptJpeg(
                f"missing RST marker in progressive scan: DRI={ri} over "
                f"{units} units expects {expected} segments, scan has "
                f"{len(segs)}")
        segs = segs[:expected]
        counts = [ri] * (expected - 1) + [units - ri * (expected - 1)]
    else:
        segs, counts = [sc.data], [units]
    u0 = 0
    for seg, cnt in zip(segs, counts):
        br = H.BitReader(seg)            # predictors/EOB run reset with it
        if sc.ss == 0:
            _decode_dc_segment(br, sc, comps, acc, mcu_cols, cdims, luts,
                               u0, cnt)
        else:
            _decode_ac_segment(br, sc, acc, cdims, luts, u0, cnt)
        if br.bits_consumed() > 8 * br.n:
            raise CorruptJpeg(
                f"truncated progressive scan segment: consumed "
                f"{br.bits_consumed()} bits of {8 * br.n} available")
        u0 += cnt


# ------------------------------------------------------------- whole image
def decode_coefficients_progressive(spec: DecodeSpec,
                                    workers: Optional[int] = None
                                    ) -> Dict[int, np.ndarray]:
    """-> {cid: int32 [by, bx, 8, 8] natural-order coefficient blocks},
    the exact layout baseline ``decode_coefficients`` returns (by/bx =
    MCU-padded component block grid), by accumulating every scan of a
    SOF2 stream. Emits one ``jpeg.entropy`` span (mode="progressive")
    with a ``jpeg.entropy.scan`` child span per scan."""
    requested = int(workers) if workers else H.current_entropy_workers()
    if not spec.scans:
        raise CorruptJpeg("progressive stream has no scans")
    _check_script(spec)
    hmax = max(c.h for c in spec.components)
    vmax = max(c.v for c in spec.components)
    mcu_cols = (spec.width + 8 * hmax - 1) // (8 * hmax)
    mcu_rows = (spec.height + 8 * vmax - 1) // (8 * vmax)
    comps = {c.cid: c for c in spec.components}
    # zigzag-order accumulators; converted to natural order once at the end
    acc = {c.cid: np.zeros((mcu_rows * c.v, mcu_cols * c.h, 64),
                           dtype=np.int32) for c in spec.components}
    cdims: Dict[int, Tuple[int, int]] = {}
    for c in spec.components:
        sh = (spec.height * c.v + vmax - 1) // vmax
        sw = (spec.width * c.h + hmax - 1) // hmax
        cdims[c.cid] = ((sh + 7) // 8, (sw + 7) // 8)
    with trace.span("jpeg.entropy") as sp:
        sp.set(mode="progressive", scans=len(spec.scans), workers=1)
        bumps = {"serial_images": 1, "progressive_images": 1}
        if requested > 1:
            # coefficient state crosses scans: parallel requests demote
            # to serial, recorded like every other entropy fallback
            sp.set(fallback="fallback_progressive_scan")
            trace.instant("jpeg.entropy.fallback",
                          reason="fallback_progressive_scan",
                          workers=requested)
            bumps["fallback_progressive_scan"] = 1
        H.STATS.bump(**bumps)
        for idx, sc in enumerate(spec.scans):
            with trace.span("jpeg.entropy.scan", index=idx, ss=sc.ss,
                            se=sc.se, ah=sc.ah, al=sc.al,
                            comps=len(sc.comps)):
                _decode_scan(sc, comps, acc, mcu_rows, mcu_cols, cdims)
    out: Dict[int, np.ndarray] = {}
    for c in spec.components:
        by, bx, _ = acc[c.cid].shape
        nat = np.zeros((by, bx, 64), dtype=np.int32)
        nat[:, :, T.ZIGZAG] = acc[c.cid]
        out[c.cid] = nat.reshape(by, bx, 8, 8)
    return out
