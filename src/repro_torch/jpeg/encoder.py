"""Baseline JPEG encoder (numpy) — corpus generator for the benchmark.

Writes real JFIF byte streams: SOI/APP0/DQT/SOF0/DHT/SOS/EOI, standard
Annex-K Huffman tables, 4:4:4 or 4:2:0 subsampling, quality-scaled
quantization, interleaved MCUs, byte stuffing. Also writes the *rare* JPEG
mode the paper's robustness finding keys on (ImageNet-val index 19876): a
4-component Adobe (APP14, transform=2) YCCK image that strict decoders
reject.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from repro_torch.jpeg import tables as T


# ---------------------------------------------------------------- bit writer
class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.buf.append(b)
            if b == 0xFF:
                self.buf.append(0x00)          # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def align(self) -> None:
        """Pad with 1s to the next byte boundary (stuffing still applies)."""
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)

    def emit_marker(self, marker: int) -> None:
        """Byte-align, then splice a raw (unstuffed) marker into the
        stream — how RSTn markers land between restart intervals."""
        self.align()
        self.buf += bytes([0xFF, marker])

    def flush(self) -> bytes:
        self.align()                           # pad with 1s
        return bytes(self.buf)


def _magnitude(v: int) -> Tuple[int, int]:
    """JPEG magnitude category + offset bits."""
    if v == 0:
        return 0, 0
    size = int(abs(v)).bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


# ---------------------------------------------------------------- transforms
def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [n_blocks, 8, 8] raster MCU order."""
    H, W = plane.shape
    return (plane.reshape(H // 8, 8, W // 8, 8)
                 .transpose(0, 2, 1, 3).reshape(-1, 8, 8))


def _fdct_quant(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    c = T.dct_matrix()
    shifted = blocks.astype(np.float64) - 128.0
    coef = np.einsum("ki,nij,lj->nkl", c, shifted, c)
    return np.round(coef / q[None]).astype(np.int32)


def _pad_to(img: np.ndarray, mh: int, mw: int) -> np.ndarray:
    H, W = img.shape[:2]
    ph = (mh - H % mh) % mh
    pw = (mw - W % mw) % mw
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2),
                     mode="edge")
    return img


# ---------------------------------------------------------------- segments
def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _dqt(tid: int, q: np.ndarray) -> bytes:
    zz = q.reshape(-1)[T.ZIGZAG].astype(np.uint8)
    return _seg(0xDB, bytes([tid]) + zz.tobytes())


def _dht(tc: int, th: int, bits, vals) -> bytes:
    return _seg(0xC4, bytes([(tc << 4) | th]) + bytes(bits[1:17])
                + bytes(vals))


def _sof(marker: int, h: int, w: int, comps) -> bytes:
    p = struct.pack(">BHHB", 8, h, w, len(comps))
    for cid, hs, vs, tq in comps:
        p += bytes([cid, (hs << 4) | vs, tq])
    return _seg(marker, p)


def _sof0(h: int, w: int, comps) -> bytes:
    return _sof(0xC0, h, w, comps)


def _sos(comps, ss: int = 0, se: int = 63, ah: int = 0,
         al: int = 0) -> bytes:
    p = bytes([len(comps)])
    for cid, td, ta in comps:
        p += bytes([cid, (td << 4) | ta])
    p += bytes([ss, se, (ah << 4) | al])
    return _seg(0xDA, p)


_APP0 = _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _dri(interval: int) -> bytes:
    return _seg(0xDD, struct.pack(">H", interval))


def _app14_adobe(transform: int) -> bytes:
    return _seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


# ---------------------------------------------------------------- encoder
def _encode_component_blocks(coefs: np.ndarray, dc_codes, ac_codes,
                             bw: BitWriter, dc_pred: int) -> int:
    zz = coefs.reshape(coefs.shape[0], 64)[:, T.ZIGZAG]
    for blk in zz:
        diff = int(blk[0]) - dc_pred
        dc_pred = int(blk[0])
        size, bits = _magnitude(diff)
        code, length = dc_codes[size]
        bw.write(code, length)
        if size:
            bw.write(bits, size)
        run = 0
        last_nz = np.nonzero(blk[1:])[0]
        end = last_nz[-1] + 1 if len(last_nz) else 0
        for k in range(1, end + 1):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                code, length = ac_codes[0xF0]
                bw.write(code, length)
                run -= 16
            size, bits = _magnitude(v)
            code, length = ac_codes[(run << 4) | size]
            bw.write(code, length)
            bw.write(bits, size)
            run = 0
        if end < 63:
            code, length = ac_codes[0x00]      # EOB
            bw.write(code, length)
    return dc_pred


# ------------------------------------------------------- progressive encoder
def scan_script(preset: str, n_comps: int) -> list:
    """Named scan-script presets -> [(comp_indices, Ss, Se, Ah, Al), ...].

    ``"standard"`` is the libjpeg jcparam.c 10-scan successive-
    approximation script for 3 components (generalized for other counts);
    ``"spectral"`` is pure spectral selection (DC, then two AC bands per
    component) with no successive approximation.
    """
    everyone = tuple(range(n_comps))
    if preset == "spectral":
        script = [(everyone, 0, 0, 0, 0)]
        for i in range(n_comps):
            script += [((i,), 1, 5, 0, 0), ((i,), 6, 63, 0, 0)]
        return script
    if preset == "standard":
        if n_comps == 3:
            return [
                ((0, 1, 2), 0, 0, 0, 1),
                ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0),
            ]
        script = [(everyone, 0, 0, 0, 1)]
        script += [((i,), 1, 63, 0, 1) for i in range(n_comps)]
        script += [(everyone, 0, 0, 1, 0)]
        script += [((i,), 1, 63, 1, 0) for i in range(n_comps)]
        return script
    raise ValueError(f"unknown scan script preset {preset!r}")


def _resolve_script(script, n_comps: int) -> list:
    return scan_script(script, n_comps) if isinstance(script, str) \
        else list(script)


def _zz_grid(blocks: np.ndarray, gy: int, gx: int) -> np.ndarray:
    """[n, 8, 8] natural-order raster blocks -> zigzag [gy, gx, 64]."""
    return blocks.reshape(gy * gx, 64)[:, T.ZIGZAG].reshape(gy, gx, 64)


# The fixed Annex-K AC tables define EOB0 (0x00) but none of the EOBn
# run symbols (0x10..0xE0) optimized-table encoders use, so the EOB run
# is capped at one block: every block ending early emits its own EOB0.
# Decode-side EOBn handling is exercised by optimized-table streams from
# independent encoders (the Pillow cross-checks).
_MAX_EOBRUN = 1


class _AcScanState:
    """jcphuff-style AC-scan encoder state: the EOB run counter and the
    correction bits buffered behind it (emitted after the EOBn symbol)."""

    def __init__(self, bw: BitWriter, ac_codes):
        self.bw = bw
        self.ac = ac_codes
        self.eobrun = 0
        self.pending = []          # correction bits awaiting the EOBn flush

    def flush_eobrun(self) -> None:
        if self.eobrun > 0:
            nbits = self.eobrun.bit_length() - 1
            code, length = self.ac[nbits << 4]
            self.bw.write(code, length)
            if nbits:
                self.bw.write(self.eobrun & ((1 << nbits) - 1), nbits)
            self.eobrun = 0
            for b in self.pending:
                self.bw.write(b, 1)
            self.pending = []


def _enc_ac_first_block(st: _AcScanState, blk_zz: np.ndarray, ss: int,
                        se: int, al: int) -> None:
    bw, ac = st.bw, st.ac
    r = 0
    for k in range(ss, se + 1):
        v = int(blk_zz[k])
        av = (v if v >= 0 else -v) >> al
        if av == 0:
            r += 1
            continue
        st.flush_eobrun()
        while r > 15:
            code, length = ac[0xF0]
            bw.write(code, length)
            r -= 16
        size, bits = _magnitude(av if v >= 0 else -av)
        code, length = ac[(r << 4) | size]
        bw.write(code, length)
        bw.write(bits, size)
        r = 0
    if r > 0:
        st.eobrun += 1
        if st.eobrun >= _MAX_EOBRUN:
            st.flush_eobrun()


def _enc_ac_refine_block(st: _AcScanState, blk_zz: np.ndarray, ss: int,
                         se: int, al: int) -> None:
    bw, ac = st.bw, st.ac
    vals = [int(x) for x in blk_zz[ss:se + 1]]
    absv = [(v if v >= 0 else -v) >> al for v in vals]
    eob = ss - 1                   # index of last newly-nonzero coefficient
    for j, a in enumerate(absv):
        if a == 1:
            eob = ss + j
    r = 0
    br_bits = []                   # this block's unemitted correction bits
    for j, a in enumerate(absv):
        k = ss + j
        if a == 0:
            r += 1
            continue
        while r > 15 and k <= eob:
            st.flush_eobrun()
            code, length = ac[0xF0]
            bw.write(code, length)
            r -= 16
            for b in br_bits:
                bw.write(b, 1)
            br_bits = []
        if a > 1:                  # history-nonzero: one correction bit
            br_bits.append(a & 1)
            continue
        st.flush_eobrun()          # newly nonzero: (run, 1) + sign bit
        code, length = ac[(r << 4) | 1]
        bw.write(code, length)
        bw.write(1 if vals[j] >= 0 else 0, 1)
        r = 0
        for b in br_bits:
            bw.write(b, 1)
        br_bits = []
    if r > 0 or br_bits:
        st.eobrun += 1
        st.pending.extend(br_bits)
        if st.eobrun >= _MAX_EOBRUN:
            st.flush_eobrun()


def _enc_dc_scan(bw: BitWriter, cis, grids, samp, cdims, mbx: int,
                 units: int, tsel, codes, ah: int, al: int,
                 ri: int) -> None:
    interleaved = len(cis) > 1
    preds = {i: 0 for i in cis}
    for u in range(units):
        if interleaved:
            my, mx = divmod(u, mbx)
            for i in cis:
                h, v = samp[i]
                g = grids[i]
                for dy in range(v):
                    for dx in range(h):
                        dc = int(g[my * v + dy, mx * h + dx, 0])
                        if ah == 0:
                            val = dc >> al
                            size, bits = _magnitude(val - preds[i])
                            preds[i] = val
                            code, length = codes[(0, tsel[i][0])][size]
                            bw.write(code, length)
                            if size:
                                bw.write(bits, size)
                        else:
                            bw.write((dc >> al) & 1, 1)
        else:
            i = cis[0]
            _, cx = cdims[i]
            by, bx = divmod(u, cx)
            dc = int(grids[i][by, bx, 0])
            if ah == 0:
                val = dc >> al
                size, bits = _magnitude(val - preds[i])
                preds[i] = val
                code, length = codes[(0, tsel[i][0])][size]
                bw.write(code, length)
                if size:
                    bw.write(bits, size)
            else:
                bw.write((dc >> al) & 1, 1)
        if ri and (u + 1) % ri == 0 and u + 1 < units:
            bw.emit_marker(0xD0 + ((u + 1) // ri - 1) % 8)
            preds = {i: 0 for i in cis}


def _enc_ac_scan(bw: BitWriter, grid, cdim, ac_codes, ss: int, se: int,
                 ah: int, al: int, ri: int) -> None:
    cy, cx = cdim
    units = cy * cx
    st = _AcScanState(bw, ac_codes)
    block_fn = _enc_ac_first_block if ah == 0 else _enc_ac_refine_block
    for u in range(units):
        by, bx = divmod(u, cx)
        block_fn(st, grid[by, bx], ss, se, al)
        if ri and (u + 1) % ri == 0 and u + 1 < units:
            st.flush_eobrun()
            bw.emit_marker(0xD0 + ((u + 1) // ri - 1) % 8)
    st.flush_eobrun()


def _emit_progressive_scans(grids, samp, cdims, mbx: int, n_mcus: int,
                            cids, tsel, codes, script, ri: int) -> bytes:
    """One SOS segment + entropy bytes per scan-script entry. Interleaved
    (multi-component) scans walk the MCU grid; single-component scans
    walk that component's own ceil-dims block grid. ``ri`` > 0 plants an
    RSTn every ``ri`` units of whichever unit the scan uses."""
    parts = []
    for cis, ss, se, ah, al in script:
        bw = BitWriter()
        if ss == 0:
            units = n_mcus if len(cis) > 1 else (
                cdims[cis[0]][0] * cdims[cis[0]][1])
            _enc_dc_scan(bw, cis, grids, samp, cdims, mbx, units, tsel,
                         codes, ah, al, ri)
        else:
            i = cis[0]
            _enc_ac_scan(bw, grids[i], cdims[i], codes[(1, tsel[i][1])],
                         ss, se, ah, al, ri)
        parts.append(_sos([(cids[i],) + tsel[i] for i in cis],
                          ss, se, ah, al) + bw.flush())
    return b"".join(parts)


def _ceil_block_dims(H: int, W: int, samp) -> list:
    """Per-component ceil-dims block grids (T.81 A.2.2) — what
    non-interleaved scans cover; MCU-padding blocks beyond them carry no
    scan data (their content is cropped away anyway)."""
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    out = []
    for h, v in samp:
        sh = (H * v + vmax - 1) // vmax
        sw = (W * h + hmax - 1) // hmax
        out.append(((sh + 7) // 8, (sw + 7) // 8))
    return out


def _encode_progressive(rgb: np.ndarray, quality: int, subsampling: str,
                        ri: int, script) -> bytes:
    H, W = rgb.shape[:2]
    qy = T.quality_scale(T.STD_LUMA_Q, quality)
    qc = T.quality_scale(T.STD_CHROMA_Q, quality)
    ycc = rgb_to_ycbcr(rgb)
    if subsampling == "444":
        img = _pad_to(ycc, 8, 8)
        gy, gx = img.shape[0] // 8, img.shape[1] // 8
        grids = [_zz_grid(_fdct_quant(_to_blocks(img[..., i]),
                                      qy if i == 0 else qc), gy, gx)
                 for i in range(3)]
        samp = [(1, 1)] * 3
        mby, mbx = gy, gx
        sof_comps = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    elif subsampling == "420":
        img = _pad_to(ycc, 16, 16)
        cb = img[..., 1].reshape(img.shape[0] // 2, 2,
                                 img.shape[1] // 2, 2).mean(axis=(1, 3))
        cr = img[..., 2].reshape(img.shape[0] // 2, 2,
                                 img.shape[1] // 2, 2).mean(axis=(1, 3))
        ygy, ygx = img.shape[0] // 8, img.shape[1] // 8
        mby, mbx = img.shape[0] // 16, img.shape[1] // 16
        grids = [_zz_grid(_fdct_quant(_to_blocks(img[..., 0]), qy),
                          ygy, ygx),
                 _zz_grid(_fdct_quant(_to_blocks(cb), qc), mby, mbx),
                 _zz_grid(_fdct_quant(_to_blocks(cr), qc), mby, mbx)]
        samp = [(2, 2), (1, 1), (1, 1)]
        sof_comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    else:
        raise ValueError(subsampling)
    codes = {
        (0, 0): T.canonical_codes(T.DC_LUMA_BITS, T.DC_LUMA_VALS),
        (1, 0): T.canonical_codes(T.AC_LUMA_BITS, T.AC_LUMA_VALS),
        (0, 1): T.canonical_codes(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS),
        (1, 1): T.canonical_codes(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS),
    }
    script = _resolve_script(script, 3)
    body = _emit_progressive_scans(
        grids, samp, _ceil_block_dims(H, W, samp), mbx, mby * mbx,
        [1, 2, 3], [(0, 0), (1, 1), (1, 1)], codes, script, ri)
    out = b"\xff\xd8" + _APP0 + _dqt(0, qy) + _dqt(1, qc)
    out += _sof(0xC2, H, W, sof_comps)
    out += _dht(0, 0, T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    out += _dht(1, 0, T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    out += _dht(0, 1, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    out += _dht(1, 1, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    if ri:
        out += _dri(ri)
    return out + body + b"\xff\xd9"


def encode_jpeg(rgb: np.ndarray, quality: int = 85,
                subsampling: str = "420",
                restart_interval: int = 0,
                progressive: bool = False,
                scan_script: "str | list" = "standard") -> bytes:
    """rgb: [H, W, 3] uint8 -> baseline JFIF bytes.

    ``restart_interval`` > 0 emits a DRI segment and an RSTn marker every
    that many MCUs (byte-aligned, DC predictors reset) — the common real
    ImageNet-file structure the restart-aware decoder is tested against.

    ``progressive=True`` emits a SOF2 multi-scan stream instead;
    ``scan_script`` is a preset name (see ``scan_script()``) or an
    explicit ``[(comp_indices, Ss, Se, Ah, Al), ...]`` list. The baseline
    byte path is untouched by these knobs, keeping existing corpus
    fingerprints stable.
    """
    if progressive:
        return _encode_progressive(rgb, quality, subsampling,
                                   int(restart_interval), scan_script)
    H, W = rgb.shape[:2]
    ri = int(restart_interval)
    qy = T.quality_scale(T.STD_LUMA_Q, quality)
    qc = T.quality_scale(T.STD_CHROMA_Q, quality)
    ycc = rgb_to_ycbcr(rgb)

    dc_l = T.canonical_codes(T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    ac_l = T.canonical_codes(T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    dc_c = T.canonical_codes(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    ac_c = T.canonical_codes(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)

    bw = BitWriter()
    if subsampling == "444":
        img = _pad_to(ycc, 8, 8)
        comps = [_fdct_quant(_to_blocks(img[..., i]), qy if i == 0 else qc)
                 for i in range(3)]
        mby, mbx = img.shape[0] // 8, img.shape[1] // 8
        preds = [0, 0, 0]
        mcu_done = 0
        for my in range(mby):
            for mx in range(mbx):
                bi = my * mbx + mx
                for ci in range(3):
                    dc, ac = (dc_l, ac_l) if ci == 0 else (dc_c, ac_c)
                    preds[ci] = _encode_component_blocks(
                        comps[ci][bi:bi + 1], dc, ac, bw, preds[ci])
                mcu_done += 1
                if ri and mcu_done % ri == 0 and mcu_done < mby * mbx:
                    bw.emit_marker(0xD0 + (mcu_done // ri - 1) % 8)
                    preds = [0, 0, 0]
        sof = _sof0(H, W, [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)])
    elif subsampling == "420":
        img = _pad_to(ycc, 16, 16)
        y = img[..., 0]
        cb = img[..., 1].reshape(img.shape[0] // 2, 2,
                                 img.shape[1] // 2, 2).mean(axis=(1, 3))
        cr = img[..., 2].reshape(img.shape[0] // 2, 2,
                                 img.shape[1] // 2, 2).mean(axis=(1, 3))
        yb = _fdct_quant(_to_blocks(y), qy)
        cbb = _fdct_quant(_to_blocks(cb), qc)
        crb = _fdct_quant(_to_blocks(cr), qc)
        mby, mbx = img.shape[0] // 16, img.shape[1] // 16
        ybx = img.shape[1] // 8
        preds = [0, 0, 0]
        mcu_done = 0
        for my in range(mby):
            for mx in range(mbx):
                for dy in range(2):
                    for dx in range(2):
                        bi = (2 * my + dy) * ybx + 2 * mx + dx
                        preds[0] = _encode_component_blocks(
                            yb[bi:bi + 1], dc_l, ac_l, bw, preds[0])
                ci = my * (mbx) + mx
                preds[1] = _encode_component_blocks(
                    cbb[ci:ci + 1], dc_c, ac_c, bw, preds[1])
                preds[2] = _encode_component_blocks(
                    crb[ci:ci + 1], dc_c, ac_c, bw, preds[2])
                mcu_done += 1
                if ri and mcu_done % ri == 0 and mcu_done < mby * mbx:
                    bw.emit_marker(0xD0 + (mcu_done // ri - 1) % 8)
                    preds = [0, 0, 0]
        sof = _sof0(H, W, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)])
    else:
        raise ValueError(subsampling)

    out = b"\xff\xd8" + _APP0 + _dqt(0, qy) + _dqt(1, qc) + sof
    out += _dht(0, 0, T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    out += _dht(1, 0, T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    out += _dht(0, 1, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    out += _dht(1, 1, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    if ri:
        out += _dri(ri)
    out += _sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)])
    out += bw.flush() + b"\xff\xd9"
    return out


def encode_jpeg_ycck(rgb: np.ndarray, quality: int = 85,
                     progressive: bool = False,
                     scan_script: "str | list" = "standard") -> bytes:
    """The rare mode: 4-component Adobe YCCK (APP14 transform=2), 4:4:4.

    Strict decoders (the ajpegli/jpeg4py/kornia-rs/turbojpeg analogues)
    reject this; tolerant decoders invert YCCK->CMYK->RGB.
    ``progressive=True`` stacks the rare color mode on a SOF2 scan
    sequence (both refusal reasons at once).
    """
    H, W = rgb.shape[:2]
    # RGB -> CMYK (naive) -> YCCK: Y/Cb/Cr of (255-C,255-M,255-Y'), K plane
    rgbf = rgb.astype(np.float64)
    k = 255.0 - rgbf.max(axis=-1)
    denom = np.maximum(255.0 - k, 1e-6)
    c = (255.0 - rgbf[..., 0] - k) / denom * 255.0
    m = (255.0 - rgbf[..., 1] - k) / denom * 255.0
    yl = (255.0 - rgbf[..., 2] - k) / denom * 255.0
    inv = np.stack([255.0 - c, 255.0 - m, 255.0 - yl], axis=-1)
    ycc = rgb_to_ycbcr(np.clip(inv, 0, 255))
    four = np.concatenate([ycc, k[..., None]], axis=-1)

    qy = T.quality_scale(T.STD_LUMA_Q, quality)
    qc = T.quality_scale(T.STD_CHROMA_Q, quality)
    img = _pad_to(four, 8, 8)
    qsel = [qy, qc, qc, qy]
    if progressive:
        gy, gx = img.shape[0] // 8, img.shape[1] // 8
        grids = [_zz_grid(_fdct_quant(_to_blocks(img[..., i]), qsel[i]),
                          gy, gx) for i in range(4)]
        samp = [(1, 1)] * 4
        codes = {
            (0, 0): T.canonical_codes(T.DC_LUMA_BITS, T.DC_LUMA_VALS),
            (1, 0): T.canonical_codes(T.AC_LUMA_BITS, T.AC_LUMA_VALS),
            (0, 1): T.canonical_codes(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS),
            (1, 1): T.canonical_codes(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS),
        }
        body = _emit_progressive_scans(
            grids, samp, _ceil_block_dims(H, W, samp), gx, gy * gx,
            [1, 2, 3, 4], [(0, 0), (1, 1), (1, 1), (0, 0)], codes,
            _resolve_script(scan_script, 4), 0)
        out = b"\xff\xd8" + _app14_adobe(2) + _dqt(0, qy) + _dqt(1, qc)
        out += _sof(0xC2, H, W, [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1),
                                 (4, 1, 1, 0)])
        out += _dht(0, 0, T.DC_LUMA_BITS, T.DC_LUMA_VALS)
        out += _dht(1, 0, T.AC_LUMA_BITS, T.AC_LUMA_VALS)
        out += _dht(0, 1, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
        out += _dht(1, 1, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
        return out + body + b"\xff\xd9"
    comps = [_fdct_quant(_to_blocks(img[..., i]), qsel[i]) for i in range(4)]

    dc_l = T.canonical_codes(T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    ac_l = T.canonical_codes(T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    dc_c = T.canonical_codes(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    ac_c = T.canonical_codes(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    bw = BitWriter()
    mby, mbx = img.shape[0] // 8, img.shape[1] // 8
    preds = [0, 0, 0, 0]
    tsel = [(dc_l, ac_l), (dc_c, ac_c), (dc_c, ac_c), (dc_l, ac_l)]
    for my in range(mby):
        for mx in range(mbx):
            bi = my * mbx + mx
            for ci in range(4):
                dc, ac = tsel[ci]
                preds[ci] = _encode_component_blocks(
                    comps[ci][bi:bi + 1], dc, ac, bw, preds[ci])

    sof = _sof0(H, W, [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1),
                       (4, 1, 1, 0)])
    out = b"\xff\xd8" + _app14_adobe(2) + _dqt(0, qy) + _dqt(1, qc) + sof
    out += _dht(0, 0, T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    out += _dht(1, 0, T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    out += _dht(0, 1, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
    out += _dht(1, 1, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    out += _sos([(1, 0, 0), (2, 1, 1), (3, 1, 1), (4, 0, 0)])
    out += bw.flush() + b"\xff\xd9"
    return out
