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
libjpeg-turbo's output. As ``jdsample.c`` does, chroma planes of 2 or
fewer samples across are upsampled 2x horizontally by replication, not by
the triangle filter (4:2:0 by replication both ways). Entropy
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
    if fx == 2 and plane.shape[1] <= 2:  # jdsample.c: fancy only above 2 samples
        return np.repeat(np.repeat(plane.astype(np.int32), 2, 1), fy, 0)
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


# ---------------------------------------------------------------------------
# baseline encoding: cv2.imencode(".jpg", img) at its defaults
# ---------------------------------------------------------------------------

# ITU-T T.81 Annex K.1 quantisation tables, natural order
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99], np.int64)
# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_STD_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_STD_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_STD_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
    "1718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a"
    "737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
    "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_STD_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
    "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
_ZZ = np.asarray(_ZIGZAG)


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``'s scaling."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(counts, symbols):
    """Canonical Huffman codes -> (code (256,), length (256,)) by symbol."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]], size[symbols[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """``jccolor.c``'s fixed-point RGB -> YCbCr, (..., 3) uint8 -> int64."""
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + (128 << 16) + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + (128 << 16) + half - 1) >> 16
    return np.stack([y, cb, cr], axis=-1)


def _fdct_1d(d, axis: int, final: bool):
    """One pass of ``jfdctint.c``'s ``jpeg_fdct_islow`` along ``axis``."""
    s = [np.take(d, i, axis=axis) for i in range(8)]
    tmp0, tmp7 = s[0] + s[7], s[0] - s[7]
    tmp1, tmp6 = s[1] + s[6], s[1] - s[6]
    tmp2, tmp5 = s[2] + s[5], s[2] - s[5]
    tmp3, tmp4 = s[3] + s[4], s[3] - s[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = _CONST_BITS + _PASS1_BITS if final else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if final:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 - tmp12 * _F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return np.stack(out, axis=axis)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) samples -> (N, 8, 8) DCT coefficients scaled by 8, as
    ``jpeg_fdct_islow`` computes them (rows, then columns)."""
    d = blocks.astype(np.int64) - 128
    return _fdct_1d(_fdct_1d(d, 2, False), 1, True)


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantiser: the division by 8 q as a multiplication by
    its 16-bit reciprocal (``compute_reciprocal``), sign handled apart."""
    div = qtable << 3
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (np.int64(1) << r) // div, (np.int64(1) << r) % div
    c = div // 2
    exact = fr == 0
    fq = np.where(exact, fq >> 1, np.where(fr <= div // 2, fq, fq + 1))
    r = np.where(exact, r - 1, r)
    c = np.where(~exact & (fr <= div // 2), c + 1, c)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(H, W) plane edge-replicated to (8 bh, 8 bw) -> (bh, bw, 8, 8)."""
    h, w = plane.shape
    p = np.pad(plane, ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _h2v2_downsample(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``jcsample.c``'s ``h2v2_downsample``: 2 x 2 sums plus a bias of 1, 2,
    1, 2, ... along each row, over the plane edge-replicated to twice the
    output size."""
    h, w = plane.shape
    p = np.pad(plane, ((0, 2 * out_h - h), (0, 2 * out_w - w)), mode="edge")
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_w) % 2 == 0, 1, 2)
    return (s + bias[None, :]) >> 2


def _huffman_events(q: np.ndarray, comp: np.ndarray, dc_tabs, ac_tabs):
    """Coded bits of the blocks ``q`` (N, 64 zigzag) in scan order, block n
    of component ``comp[n]``: -> (values, lengths) of every emitted code
    with its appended magnitude bits, in stream order."""
    n = len(q)
    # DC: differences from the previous block of the same component
    dc = q[:, 0]
    pred = np.zeros(n, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        pred[idx[1:]] = dc[idx[:-1]]
    diff = dc - pred
    # per-event arrays: block, order key within block, symbol table, symbol, value
    nb_dc = _nbits(diff)
    ev_block = [np.arange(n)]
    ev_key = [np.zeros(n, np.int64)]
    ev_ac = [np.zeros(n, bool)]
    ev_sym = [nb_dc]
    ev_val = [diff]
    ev_nb = [nb_dc]
    # AC: run lengths of zeros before each nonzero coefficient
    blk, k = np.nonzero(q[:, 1:])
    k = k + 1
    first = np.r_[True, blk[1:] != blk[:-1]] if len(blk) else np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    nzrl = run >> 4
    val = q[blk, k]
    nb = _nbits(val)
    # ZRLs (16 zeros each) precede their coefficient
    zb = np.repeat(blk, nzrl)
    zk = np.repeat(2 * k, nzrl) - 1  # just before the coefficient's key 2k
    ev_block += [blk, zb]
    ev_key += [2 * k, zk]
    ev_ac += [np.ones(len(blk), bool), np.ones(len(zb), bool)]
    ev_sym += [((run & 15) << 4) | nb, np.full(len(zb), 0xF0, np.int64)]
    ev_val += [val, np.zeros(len(zb), np.int64)]
    ev_nb += [nb, np.zeros(len(zb), np.int64)]
    # EOB after the last nonzero coefficient unless it is the 63rd
    last = np.zeros(n, np.int64)
    if len(blk):
        last[blk] = k  # the last write per block wins: k ascends within a block
    eob = np.nonzero(last < 63)[0]
    ev_block.append(eob)
    ev_key.append(np.full(len(eob), 200, np.int64))
    ev_ac.append(np.ones(len(eob), bool))
    ev_sym.append(np.zeros(len(eob), np.int64))
    ev_val.append(np.zeros(len(eob), np.int64))
    ev_nb.append(np.zeros(len(eob), np.int64))

    block, key = np.concatenate(ev_block), np.concatenate(ev_key)
    is_ac, sym = np.concatenate(ev_ac), np.concatenate(ev_sym)
    val, nb = np.concatenate(ev_val), np.concatenate(ev_nb)
    order = np.lexsort((key, block))
    block, is_ac, sym, val, nb = block[order], is_ac[order], sym[order], val[order], nb[order]
    c = comp[block]
    code = np.zeros(len(sym), np.int64)
    size = np.zeros(len(sym), np.int64)
    for t in range(len(dc_tabs)):
        for tabs, ac in ((dc_tabs, False), (ac_tabs, True)):
            m = (c == t) & (is_ac == ac)
            code[m], size[m] = tabs[t][0][sym[m]], tabs[t][1][sym[m]]
    extra = np.where(val < 0, val - 1, val) & ((np.int64(1) << nb) - 1)
    return (code << nb) | extra, size + nb


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    nb = np.zeros(a.shape, np.int64)
    nz = a > 0
    nb[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return nb


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate codes MSB first, pad the last byte with 1 bits and stuff
    a 0 after every 0xFF byte."""
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    ev = np.repeat(np.arange(len(values)), lengths)
    j = np.arange(total) - np.repeat(start, lengths)  # bit index within its code
    bits = (values[ev] >> (lengths[ev] - 1 - j)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = data == 0xFF
    out = np.zeros(len(data) + int(ff.sum()), np.uint8)
    pos = np.arange(len(data)) + np.cumsum(ff) - ff
    out[pos] = data
    return out.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of ``cv2.imencode(".jpg", img)`` at its defaults for a
    (H, W, 3) uint8 BGR or (H, W) grey image: baseline, JFIF 1.01, the
    Annex K tables scaled to ``quality``, 4:2:0 chroma, standard Huffman
    tables, no restart markers; libjpeg's fixed-point colour conversion
    (``jccolor.c``), ``h2v2_downsample`` (``jcsample.c``), ``islow``
    forward DCT (``jfdctint.c``) and libjpeg-turbo's quantiser, with the
    padding and dummy blocks of ``jccoefct.c`` at the image's right and
    bottom edges. Vectorised over all blocks; the Huffman codes are
    concatenated at their cumulative bit offsets."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(
            f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    H, W = img.shape[:2]
    qt = [_quality_table(_STD_LUMA_Q, quality), _quality_table(_STD_CHROMA_Q, quality)]
    dc_tabs = [_code_table(*_STD_DC_LUMA), _code_table(*_STD_DC_CHROMA)]
    ac_tabs = [_code_table(*_STD_AC_LUMA), _code_table(*_STD_AC_CHROMA)]
    grey = img.ndim == 2
    if grey:
        bh, bw = -(-H // 8), -(-W // 8)
        q = _quantize(fdct_islow(_blocks(img.astype(np.int64), bh, bw).reshape(-1, 8, 8))
                      .reshape(-1, 64), qt[0])
        scan = q[:, _ZZ]
        comp = np.zeros(len(scan), np.int64)
        comps = [(1, 0x11, 0)]
    else:
        ycc = _rgb_to_ycc(img[..., ::-1])
        my, mx = -(-H // 16), -(-W // 16)
        ybh, ybw = -(-H // 8), -(-W // 8)
        yq = _quantize(fdct_islow(_blocks(ycc[..., 0], ybh, ybw).reshape(-1, 8, 8))
                       .reshape(ybh, ybw, 64), qt[0])
        # dummy blocks fill the last MCU column and row: DC of the block
        # before them, AC zero
        full = np.zeros((2 * my, 2 * mx, 64), np.int64)
        full[:ybh, :ybw] = yq
        if ybw % 2:
            full[:ybh, ybw, 0] = yq[:, ybw - 1, 0]
        if ybh % 2:
            full[ybh, :, 0] = full[ybh - 1, 1::2, 0].repeat(2)
        chroma = []
        for ci in (1, 2):
            sub = _h2v2_downsample(ycc[..., ci], -(-H // 2), 8 * mx)
            blk = _blocks(sub, my, mx).reshape(-1, 8, 8)
            chroma.append(_quantize(fdct_islow(blk).reshape(my, mx, 64), qt[1]))
        # MCU: Y00 Y01 Y10 Y11 Cb Cr
        yb = full.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
        mcu = np.concatenate([yb, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
        scan = mcu.reshape(-1, 64)[:, _ZZ]
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    table_of = np.array([t for _, _, t in comps])
    values, lengths = _huffman_events(scan, comp, [dc_tabs[t] for t in table_of],
                                      [ac_tabs[t] for t in table_of])

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in sorted(set(table_of.tolist())):
        out.append(_segment(0xDB, bytes([t]) + bytes(qt[t][_ZZ].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, len(comps)) + b"".join(
        bytes([cid, samp, t]) for cid, samp, t in comps)))
    for t in sorted(set(table_of.tolist())):
        for cls, (counts, syms) in ((0, (_STD_DC_LUMA, _STD_DC_CHROMA)[t]),
                                    (1, (_STD_AC_LUMA, _STD_AC_CHROMA)[t])):
            out.append(_segment(0xC4, bytes([cls << 4 | t]) + bytes(counts) + bytes(syms)))
    out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, t << 4 | t]) for cid, _, t in comps) + b"\x00\x3f\x00"))
    out.append(_pack_bits(values, lengths))
    out.append(b"\xff\xd9")
    return b"".join(out)
