"""Baseline sequential JPEG decoding in numpy (ITU-T T.81), so that a colour
image written as JPEG (BlenderProc's BOP writer, cameras' snapshots) needs
no imaging package.

Supported: Huffman-coded sequential DCT frames (SOF0, and SOF1 at 8 bits)
with any Huffman tables (optimised ones included), 1 or 3 components,
interleaved and single-component scans, sampling 4:4:4, 4:2:2, 4:4:0 and
4:2:0, restart intervals, and sizes that are not multiples of the MCU.
Progressive, lossless, hierarchical, arithmetic-coded and 12-bit files and
other chroma subsamplings raise ``NotImplementedError`` naming the mode.

The output is libjpeg's default decoding, which both OpenCV and PIL return:
the ``islow`` integer IDCT (``jidctint.c``) with its range-limit table,
"fancy" triangle upsampling of subsampled chroma (``jdsample.c``), and the
fixed-point YCbCr -> RGB conversion (``jdcolor.c``); bit for bit
libjpeg-turbo's output, except on images 3 or fewer pixels wide with
subsampled chroma (where its SIMD upsampler reads past the edge). Entropy
decoding is a sequential loop over symbols with a 16-bit lookup table per
Huffman table; everything after it is vectorised over all blocks at once.
"""
from __future__ import annotations

import struct

import numpy as np

# zigzag position -> natural (row-major) index within the 8x8 block
_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
]
_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}

# jidctint.c's constants, FIX(x) at CONST_BITS = 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """The post-IDCT table of jdmaster.c, indexed by (x & 1023) for the
    IDCT's signed output x: x + 128 clamped to 0..255 over [-512, 511]."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896))
                    ).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _huffman_lut(counts, symbols) -> list:
    """A 65536-entry table: the next 16 bits of the stream -> (code length
    << 8) | symbol, 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("JPEG: bad Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(seg: bytes) -> list:
    """For every byte offset of an entropy-coded segment, the next 8 bytes
    as one big-endian integer (zeros past the end)."""
    b = np.frombuffer(seg + bytes(8), np.uint8).astype(np.uint64)
    n = len(seg) + 1
    w = np.zeros(n, np.uint64)
    for i in range(8):
        w |= b[i:i + n] << np.uint64(56 - 8 * i)
    return w.tolist()


def _decode_segment(seg: bytes, blocks: list, out_idx: list, out_val: list) -> None:
    """Entropy-decode the blocks ``[(flat base, component, dc lut, ac lut),
    ...]`` of one restart interval: (index, value) pairs of the nonzero
    quantised coefficients go to ``out_idx`` / ``out_val`` (DC values
    already undifferenced)."""
    win = _windows(seg)
    zz = _ZIGZAG
    pos = 0
    pred = {}
    append_i, append_v = out_idx.append, out_val.append
    try:
        for base, comp, dcl, acl in blocks:
            w = win[pos >> 3]
            sh = 64 - (pos & 7)
            e = dcl[(w >> (sh - 16)) & 0xFFFF]
            n = e >> 8
            if not n:
                raise ValueError("JPEG: invalid Huffman code")
            s = e & 255
            dc = pred.get(comp, 0)
            if s:
                v = (w >> (sh - n - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                dc += v
                pred[comp] = dc
            pos += n + s
            if dc:
                append_i(base)
                append_v(dc)
            k = 1
            while k < 64:
                w = win[pos >> 3]
                sh = 64 - (pos & 7)
                e = acl[(w >> (sh - 16)) & 0xFFFF]
                n = e >> 8
                if not n:
                    raise ValueError("JPEG: invalid Huffman code")
                rs = e & 255
                s = rs & 15
                if not s:
                    pos += n
                    if rs != 0xF0:
                        break  # end of block
                    k += 16
                    continue
                k += rs >> 4
                v = (w >> (sh - n - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pos += n + s
                append_i(base + zz[k])
                append_v(v)
                k += 1
            if k > 64:
                raise ValueError("JPEG: coefficient run past the end of a block")
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends early") from None


def _idct_1d(x):
    """One pass of jidctint.c over a sequence of 8 int64 arrays: the even
    and odd parts, unscaled (callers descale)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0 = o0 * _F0298 + z1 + z3
    o1 = o1 * _F2053 + z2 + z4
    o2 = o2 * _F3072 + z2 + z3
    o3 = o3 * _F1501 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients (natural order) -> (N, 8, 8)
    uint8 samples, bit for bit libjpeg's ``jpeg_idct_islow``."""
    c = coef.astype(np.int64)
    cols = _idct_1d([c[:, k, :] for k in range(8)])  # pass 1: down each column
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS) for v in cols], axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])  # pass 2: along each row
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3) for v in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(x: np.ndarray, axis: int) -> np.ndarray:
    """jdsample.c's h2v1 (and h1v2) triangle upsampling by 2 along
    ``axis``: 3/4 of the nearer sample plus 1/4 of the next, rounding
    alternately down and up, edges replicated."""
    x = np.moveaxis(x.astype(np.int32), axis, -1)
    left = np.concatenate([x[..., :1], x[..., :-1]], -1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], -1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int32)
    out[..., 0::2] = (3 * x + left + 1) >> 2
    out[..., 1::2] = (3 * x + right + 2) >> 2
    return np.moveaxis(out, -1, axis)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v2 triangle upsampling: column sums 3 x nearer row +
    farther row, then the same 3:1 mix along the row, descaled by 16 with
    rounding 8 and 7 alternately; edge rows and columns replicated."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, other in ((0, up), (1, down)):
        c = 3 * x + other
        left = np.concatenate([c[:, :1], c[:, :-1]], 1)
        right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
        out[r::2, 0::2] = (3 * c + left + 8) >> 4
        out[r::2, 1::2] = (3 * c + right + 7) >> 4
    return out


def _upsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    if (fy, fx) == (1, 1):
        return plane.astype(np.int32)
    if (fy, fx) == (2, 2):
        return _fancy_h2v2(plane)
    if (fy, fx) == (1, 2):
        return _fancy_h2(plane, 1)
    if (fy, fx) == (2, 1):
        return _fancy_h2(plane, 0)
    raise NotImplementedError(f"JPEG chroma subsampled {fx}x{fy} is not supported; "
                              f"4:4:4, 4:2:2, 4:4:0 and 4:2:0 are")


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16)."""
    half = 1 << 15
    i = np.arange(256, dtype=np.int64) - 128
    cr_r = (91881 * i + half) >> 16  # FIX(1.40200)
    cb_b = (116130 * i + half) >> 16  # FIX(1.77200)
    cr_g = -46802 * i  # -FIX(0.71414)
    cb_g = -22554 * i + half  # -FIX(0.34414), rounding folded in
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _segment_entropy_data(data: bytes, pos: int):
    """The entropy-coded data of a scan starting at ``pos``: its restart
    intervals with byte stuffing removed, and the offset of the marker
    that ends the scan."""
    segments, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG: scan data has no end marker")
        m = data[i + 1]
        if m == 0x00:
            pos = i + 2
        elif 0xD0 <= m <= 0xD7:
            segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            start = pos = i + 2
        else:
            segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            return segments, i


def decode_jpeg(data: bytes, grey: bool = False) -> np.ndarray:
    """Decode a JPEG file's bytes: (H, W) uint8 for one component, (H, W,
    3) uint8 RGB for three. ``grey``: (H, W) in every case, as libjpeg's
    greyscale output gives it (the luma plane of a YCbCr image)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt = {}
    huff = {}
    frame = None
    restart = 0
    adobe_transform = None
    coefs = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # tolerate garbage between segments, as libjpeg does
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("JPEG: no end-of-image marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack(">64H", body[i + 1:i + 129])
                    i += 129
                else:
                    vals = list(body[i + 1:i + 65])
                    i += 65
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals
                qt[tq] = q
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                huff[(tc, th)] = _huffman_lut(counts, list(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker in (0xC0, 0xC1):
            precision, h, w, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG is not supported; 8-bit is")
            if h == 0:
                raise NotImplementedError("JPEG with the height in a DNL marker is not supported")
            if nf not in (1, 3):
                raise NotImplementedError(f"JPEG with {nf} components is not supported; 1 or 3")
            comps = [dict(id=body[6 + 3 * k], h=body[7 + 3 * k] >> 4, v=body[7 + 3 * k] & 15,
                          tq=body[8 + 3 * k]) for k in range(nf)]
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            off = 0
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]  # padded block grid
                c["w"] = -(-w * c["h"] // hmax)  # sample dimensions (downsampled)
                c["ht"] = -(-h * c["v"] // vmax)
                c["off"] = off  # the component's blocks in the flat coefficient array
                off += c["bw"] * c["bh"] * 64
            frame = dict(h=h, w=w, comps=comps, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy)
            coefs = np.zeros(off, np.int64)
        elif marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(f"{_UNSUPPORTED_SOF[marker]} JPEG is not supported; "
                                      f"baseline sequential Huffman is")
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            ns = body[0]
            scan = []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                ci = next(j for j, c in enumerate(frame["comps"]) if c["id"] == cid)
                scan.append((ci, huff[(0, tables >> 4)], huff[(1, tables & 15)]))
            segments, pos = _segment_entropy_data(data, pos)
            _decode_scan(frame, scan, segments, restart, coefs)
    if frame is None:
        raise ValueError("JPEG: no frame header")
    return _reconstruct(frame, coefs, qt, adobe_transform, grey)


def _scan_blocks(frame: dict, scan: list) -> list:
    """The blocks of a scan in stream order: ``(flat coefficient base,
    component, dc lut, ac lut)``, one MCU after another."""
    comps = frame["comps"]
    if len(scan) == 1:  # non-interleaved: the component's own block raster
        ci, dcl, acl = scan[0]
        c = comps[ci]
        bw, bh = -(-c["w"] // 8), -(-c["ht"] // 8)
        return [[(c["off"] + (by * c["bw"] + bx) * 64, ci, dcl, acl)] for by in range(bh)
                for bx in range(bw)]
    mcus = []
    for my in range(frame["mcuy"]):
        for mx in range(frame["mcux"]):
            mcu = []
            for ci, dcl, acl in scan:
                c = comps[ci]
                for v in range(c["v"]):
                    for u in range(c["h"]):
                        by, bx = my * c["v"] + v, mx * c["h"] + u
                        mcu.append((c["off"] + (by * c["bw"] + bx) * 64, ci, dcl, acl))
            mcus.append(mcu)
    return mcus


def _decode_scan(frame, scan, segments, restart, coefs: np.ndarray) -> None:
    """Entropy-decode one scan into the flat coefficient array."""
    mcus = _scan_blocks(frame, scan)
    per = restart if restart else len(mcus)
    if len(segments) * per < len(mcus):
        raise ValueError("JPEG: fewer restart intervals than the scan's MCUs need")
    ii, vv = [], []
    for s, seg in enumerate(segments):
        blocks = [b for mcu in mcus[s * per:(s + 1) * per] for b in mcu]
        if blocks:
            _decode_segment(seg, blocks, ii, vv)
    coefs[np.asarray(ii, np.int64)] = np.asarray(vv, np.int64)


def _reconstruct(frame, coefs, qt, adobe_transform, grey) -> np.ndarray:
    h, w = frame["h"], frame["w"]
    ids = tuple(c["id"] for c in frame["comps"])
    rgb = adobe_transform == 0 or (adobe_transform is None and ids == (82, 71, 66))
    planes = []
    for c in frame["comps"]:
        if grey and planes and not rgb:
            break  # the luma plane is the greyscale image
        cf = coefs[c["off"]:c["off"] + c["bw"] * c["bh"] * 64]
        blk = cf.reshape(-1, 8, 8) * qt[c["tq"]].reshape(1, 8, 8)
        px = idct_islow(blk).reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3)
        px = px.reshape(c["bh"] * 8, c["bw"] * 8)[:c["ht"], :c["w"]]
        fy, fx = frame["vmax"] // c["v"], frame["hmax"] // c["h"]
        planes.append(_upsample(px, fy, fx)[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if not rgb:
        return _ycc_to_rgb(*planes)
    if grey:  # jdcolor.c's rgb_gray_convert
        r, g, b = (p.astype(np.int64) for p in planes)
        return ((19595 * r + 38470 * g + 7471 * b + (1 << 15)) >> 16).astype(np.uint8)
    return np.stack(planes, -1).astype(np.uint8)  # stored as RGB
