"""MPEG audio (MP3) decoder — SWF sound format 2.

Port of ``swf_renderer_tpu/models/mp3.py``, the same arithmetic in the
same order (the decoded PCM is byte-equal to the reference's).
MPEG-1/2/2.5 Layer III, mono and stereo (MS + intensity), pure-numpy host
decode.  MP3 is the dominant real-world DefineSound/SoundStreamBlock codec,
so the timeline mixer (runtime/audio.py) needs it.

Decode is host-side by design: SWF audio is a few hundred KB of sequential
bit-unpacking with data-dependent Huffman walks — branchy integer work that
belongs on the CPU, while the card renders frames (the same split as the
host geometry lowering).

Table provenance: the ISO/IEC 11172-3 / 13818-3 constants (Huffman tables
B.7, scalefactor-band partitions, the 257-entry synthesis-window integer
table) live in ``_mp3_tables.json``, a byte-equal copy of the reference's,
which its ``tools/extract_mp3_tables.py`` extracted from system codec
binaries' read-only data and validated (prefix-free/complete codes, band
widths summing to 576) — see that tool for the full derivation.  They are
standard data, not code.

Layer I/II and Nellymoser remain documented refusals.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass

import numpy as np

_TAB = json.loads(
    (pathlib.Path(__file__).with_name("_mp3_tables.json")).read_text())

BITRATES_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
               256, 320)
BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)
# version field (2 bits): 0 = MPEG-2.5, 2 = MPEG-2, 3 = MPEG-1
_SR_BASE = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000),
            0: (11025, 12000, 8000)}
_BAND_FAMILY = {3: 0, 2: 1, 0: 2}  # row block in the bandinfo table

_PRETAB = np.array(_TAB["pretab"], np.int32)
_CS = np.zeros(8)
_CA = np.zeros(8)
for _i, _c in enumerate((-0.6, -0.535, -0.33, -0.185, -0.095, -0.041,
                         -0.0142, -0.0037)):
    _CS[_i] = 1.0 / np.sqrt(1.0 + _c * _c)
    _CA[_i] = _c / np.sqrt(1.0 + _c * _c)


# --------------------------------------------------------------------------
# Huffman lookup tables: flat 2^maxlen LUTs built from the canonical
# (length, symbol) lists.  Codes are assigned in listing order the canonical
# way (left-aligned accumulator), which the extraction tool verifies against
# the spec's table 1 ground truth.
# --------------------------------------------------------------------------

class _HuffLut:
    __slots__ = ("maxlen", "sym", "ln", "linbits")

    def __init__(self, lens, syms, linbits):
        self.maxlen = int(max(lens)) if lens else 0
        self.linbits = linbits
        size = 1 << self.maxlen
        self.sym = np.zeros(size, np.uint8)
        self.ln = np.zeros(size, np.uint8)
        acc = 0
        for ln, sym in zip(lens, syms):
            span = 1 << (self.maxlen - ln)
            base = acc >> (32 - self.maxlen)
            self.sym[base: base + span] = sym
            self.ln[base: base + span] = ln
            acc += 1 << (32 - ln)


_LINBITS = {16: 1, 17: 2, 18: 3, 19: 4, 20: 6, 21: 8, 22: 10, 23: 13,
            24: 4, 25: 5, 26: 6, 27: 7, 28: 8, 29: 9, 30: 11, 31: 13}


def _build_tables():
    base = {}
    for t, lens in _TAB["huff_bits"].items():
        base[int(t)] = (lens, _TAB["huff_syms"][t])
    luts = {0: None}
    for t in range(1, 32):
        if t in (4, 14):
            luts[t] = None
            continue
        src = t if t in base else (16 if t < 24 else 24)
        lens, syms = base[src]
        luts[t] = _HuffLut(lens, syms, _LINBITS.get(t, 0))
    # count1 table A: lens in value order + ISO code list; build canonical
    # (length, code) -> value LUT directly.
    qa = _HuffLut([], [], 0)
    qa.maxlen = max(_TAB["quadA_len"])
    size = 1 << qa.maxlen
    qa.sym = np.zeros(size, np.uint8)
    qa.ln = np.zeros(size, np.uint8)
    for v, (ln, code) in enumerate(zip(_TAB["quadA_len"],
                                       _TAB["quadA_code"])):
        span = 1 << (qa.maxlen - ln)
        base_i = code << (qa.maxlen - ln)
        qa.sym[base_i: base_i + span] = v
        qa.ln[base_i: base_i + span] = ln
    return luts, qa


_HUFF, _QUAD_A = _build_tables()


# --------------------------------------------------------------------------
# Bit reader over the byte reservoir: the hot loops read MSB-first fields
# out of a window cached as a Python int.
# --------------------------------------------------------------------------

class _Bits:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bitpos: int = 0):
        # Trailing zero pad: reads that straddle the end of the stream
        # (truncated final frame) return zero bits instead of misaligning.
        self.data = data + b"\x00" * 8
        self.pos = bitpos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        byte0 = p >> 3
        nbytes = ((p & 7) + n + 7) >> 3
        chunk = int.from_bytes(self.data[byte0: byte0 + nbytes], "big")
        return (chunk >> (nbytes * 8 - (p & 7) - n)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p, v = self.pos, self.read(n)
        self.pos = p
        return v


# --------------------------------------------------------------------------
# Frame header / side info
# --------------------------------------------------------------------------

@dataclass
class FrameHeader:
    version: int          # 3 = MPEG-1, 2 = MPEG-2, 0 = MPEG-2.5
    bitrate: int          # kbit/s
    samplerate: int
    padding: int
    channels: int
    mode: int             # 0 stereo, 1 joint, 2 dual, 3 mono
    mode_ext: int
    crc: bool
    frame_bytes: int
    band_index: int       # row into the scalefactor-band table
    lsf: bool             # lower-sampling-frequency profile (MPEG-2/2.5)


def parse_frame_header(data: bytes, i: int):
    """Parse the 4-byte header at ``i``; None if not a Layer III sync."""
    if i + 4 > len(data):
        return None
    b0, b1, b2, b3 = data[i: i + 4]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version = (b1 >> 3) & 3
    layer = (b1 >> 1) & 3
    if version == 1 or layer != 1:       # reserved version / not Layer III
        return None
    br_idx = (b2 >> 4) & 15
    sr_idx = (b2 >> 2) & 3
    if br_idx in (0, 15) or sr_idx == 3:  # free-format unsupported
        return None
    lsf = version != 3
    bitrate = (BITRATES_V2 if lsf else BITRATES_V1)[br_idx]
    samplerate = _SR_BASE[version][sr_idx]
    padding = (b2 >> 1) & 1
    mode = (b3 >> 6) & 3
    per_frame = 72 if lsf else 144
    frame_bytes = per_frame * bitrate * 1000 // samplerate + padding
    return FrameHeader(
        version=version, bitrate=bitrate, samplerate=samplerate,
        padding=padding, channels=1 if mode == 3 else 2, mode=mode,
        mode_ext=(b3 >> 4) & 3, crc=not (b1 & 1), frame_bytes=frame_bytes,
        band_index=sr_idx + 3 * _BAND_FAMILY[version], lsf=lsf)


@dataclass
class _Granule:
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    window_switching: int = 0
    block_type: int = 0
    mixed_block: int = 0
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0


def _read_side_info(br: _Bits, h: FrameHeader):
    nch = h.channels
    if h.lsf:
        main_data_begin = br.read(8)
        br.read(1 if nch == 1 else 2)
        ngran = 1
        scfsi = [[0] * 4 for _ in range(nch)]
    else:
        main_data_begin = br.read(9)
        br.read(5 if nch == 1 else 3)
        scfsi = [[br.read(1) for _ in range(4)] for _ in range(nch)]
        ngran = 2
    granules = []
    for _g in range(ngran):
        chs = []
        for _c in range(nch):
            g = _Granule()
            g.part2_3_length = br.read(12)
            g.big_values = br.read(9)
            g.global_gain = br.read(8)
            g.scalefac_compress = br.read(9 if h.lsf else 4)
            g.window_switching = br.read(1)
            if g.window_switching:
                g.block_type = br.read(2)
                g.mixed_block = br.read(1)
                g.table_select = (br.read(5), br.read(5), 0)
                g.subblock_gain = (br.read(3), br.read(3), br.read(3))
                # implied regions under window switching (ISO 2.4.2.7)
                g.region0_count = (8 if (g.block_type == 2
                                         and not g.mixed_block) else 7)
                g.region1_count = 20 - g.region0_count
            else:
                g.table_select = (br.read(5), br.read(5), br.read(5))
                g.region0_count = br.read(4)
                g.region1_count = br.read(3)
                g.block_type = 0
            if not h.lsf:
                g.preflag = br.read(1)
            g.scalefac_scale = br.read(1)
            g.count1table_select = br.read(1)
            chs.append(g)
        granules.append(chs)
    return main_data_begin, scfsi, granules


# --------------------------------------------------------------------------
# Scalefactors
# --------------------------------------------------------------------------

_SLEN1 = (0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4)
_SLEN2 = (0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3)


def _read_scalefacs_mpeg1(br: _Bits, g: _Granule, scfsi, prev):
    sl1, sl2 = _SLEN1[g.scalefac_compress], _SLEN2[g.scalefac_compress]
    if g.window_switching and g.block_type == 2:
        sfs = np.zeros((13, 3), np.int32)
        if g.mixed_block:
            long_part = np.zeros(22, np.int32)
            for sfb in range(8):
                long_part[sfb] = br.read(sl1)
            for sfb in range(3, 6):
                for w in range(3):
                    sfs[sfb, w] = br.read(sl1)
            for sfb in range(6, 12):
                for w in range(3):
                    sfs[sfb, w] = br.read(sl2)
            return long_part, sfs
        for sfb in range(6):
            for w in range(3):
                sfs[sfb, w] = br.read(sl1)
        for sfb in range(6, 12):
            for w in range(3):
                sfs[sfb, w] = br.read(sl2)
        return None, sfs
    longf = np.zeros(22, np.int32)
    groups = ((0, 6, sl1), (6, 11, sl1), (11, 16, sl2), (16, 21, sl2))
    for gi, (a, b, sl) in enumerate(groups):
        if scfsi[gi] and prev is not None:
            longf[a:b] = prev[a:b]
        else:
            for sfb in range(a, b):
                longf[sfb] = br.read(sl)
    return longf, None


def _read_scalefacs_lsf(br: _Bits, g: _Granule, h: FrameHeader,
                        intensity_ch: bool):
    sf = g.scalefac_compress
    preflag = 0
    int_scale = 0
    if not intensity_ch:
        if sf < 400:
            slen = ((sf >> 4) // 5, (sf >> 4) % 5, (sf % 16) >> 2, sf % 4)
            blocknumber = 0
        elif sf < 500:
            sf -= 400
            slen = ((sf >> 2) // 5, (sf >> 2) % 5, sf % 4, 0)
            blocknumber = 1
        else:
            sf -= 500
            slen = (sf // 3, sf % 3, 0, 0)
            blocknumber = 2
            preflag = 1
    else:
        int_scale = sf & 1
        sf >>= 1
        if sf < 180:
            slen = (sf // 36, (sf % 36) // 6, sf % 6, 0)
            blocknumber = 3
        elif sf < 244:
            sf -= 180
            slen = ((sf % 64) >> 4, (sf % 16) >> 2, sf % 4, 0)
            blocknumber = 4
        else:
            sf -= 244
            slen = (sf // 3, sf % 3, 0, 0)
            blocknumber = 5
    kind = (1 if (g.window_switching and g.block_type == 2
                  and not g.mixed_block) else
            2 if (g.window_switching and g.block_type == 2) else 0)
    nsf = _TAB["lsf_nsf"][blocknumber][kind]
    raw = []
    for grp in range(4):
        for _ in range(nsf[grp]):
            raw.append(br.read(slen[grp]))
    raw = np.asarray(raw, np.int32)
    if g.window_switching and g.block_type == 2 and not g.mixed_block:
        sfs = np.zeros((13, 3), np.int32)
        n = min(len(raw), 36)
        sfs.flat[:n] = raw[:n]
        return None, sfs, preflag, int_scale
    longf = np.zeros(22, np.int32)
    n = min(len(raw), 22)
    longf[:n] = raw[:n]
    return longf, None, preflag, int_scale


# --------------------------------------------------------------------------
# Huffman spectrum decode
# --------------------------------------------------------------------------

def _decode_spectrum(br: _Bits, g: _Granule, h: FrameHeader, limit: int):
    """Decode 576 spectral values; ``limit`` is the absolute bit position
    where this granule's part2_3 data ends."""
    band = _TAB["bandinfo"][h.band_index]
    xs = np.zeros(576, np.float64)
    if g.window_switching:
        # Implied regions (ISO 2.4.2.7): the boundary is the 8th long band
        # (start/stop) or the 3rd short band triple (pure short) — a
        # CONSTANT 36 only at the MPEG-1 rates; LSF rates differ (54 at
        # 11.025 kHz), which corrupts every window-switching granule if
        # hardcoded.
        if g.block_type == 2 and not g.mixed_block:
            region1 = band["shortIdx"][3]
        else:
            region1 = band["longIdx"][8]
        region2 = 576
    else:
        li = band["longIdx"]
        region1 = li[min(g.region0_count + 1, 22)]
        region2 = li[min(g.region0_count + 1 + g.region1_count + 1, 22)]
    n_big = min(g.big_values * 2, 576)
    bounds = (min(region1, n_big), min(region2, n_big), n_big)
    pos = 0
    start = 0
    for r, end in enumerate(bounds):
        lut = _HUFF[g.table_select[r]]
        if lut is None:
            pos = end
            start = end
            continue
        maxlen, linbits = lut.maxlen, lut.linbits
        sym_t, ln_t = lut.sym, lut.ln
        for pos in range(start, end, 2):
            if br.pos >= limit:
                break
            code = br.peek(maxlen)
            ln = int(ln_t[code])
            if ln == 0:
                br.pos = limit
                break
            br.pos += ln
            sym = int(sym_t[code])
            x, y = sym >> 4, sym & 15
            if x == 15 and linbits:
                x += br.read(linbits)
            if x and br.read(1):
                x = -x
            if y == 15 and linbits:
                y += br.read(linbits)
            if y and br.read(1):
                y = -y
            xs[pos] = x
            xs[pos + 1] = y
        start = end
        pos = end
    # count1 region: quads until the bit budget or the spectrum runs out
    qa = _QUAD_A
    use_b = g.count1table_select
    while br.pos < limit and pos <= 572:
        mark = br.pos
        if use_b:
            v = 15 - br.read(4)
        else:
            code = br.peek(qa.maxlen)
            ln = int(qa.ln[code])
            if ln == 0:
                br.pos = limit
                break
            br.pos += ln
            v = int(qa.sym[code])
        quad = []
        for bit in (3, 2, 1, 0):
            q = (v >> bit) & 1
            if q and br.read(1):
                q = -q
            quad.append(q)
        if br.pos > limit:        # the final quad overran: roll it back
            br.pos = mark
            break
        xs[pos: pos + 4] = quad
        pos += 4
    br.pos = limit
    return xs


# --------------------------------------------------------------------------
# Requantize / reorder / stereo / antialias
# --------------------------------------------------------------------------

def _requantize(xs, g: _Granule, h: FrameHeader, longf, shortf, preflag):
    band = _TAB["bandinfo"][h.band_index]
    mul = 0.5 * (g.scalefac_scale + 1)
    out = np.sign(xs) * np.abs(xs) ** (4.0 / 3.0)
    gain = g.global_gain - 210.0
    short_block = g.window_switching and g.block_type == 2
    long_end = 576
    if short_block:
        long_end = 36 if g.mixed_block else 0
    if long_end:
        exps = np.zeros(576)
        li = band["longIdx"]
        sf = longf if longf is not None else np.zeros(22, np.int32)
        for sfb in range(22):
            a, b = li[sfb], li[sfb + 1]
            if a >= long_end:
                break
            exps[a:b] = 0.25 * gain - mul * (
                sf[sfb] + preflag * _PRETAB[sfb])
        out[:long_end] *= 2.0 ** exps[:long_end]
    if short_block:
        si = band["shortIdx"]          # premultiplied-by-3 boundaries
        sw = band["shortDiff"]
        sfs = shortf if shortf is not None else np.zeros((13, 3), np.int32)
        first_sfb = 3 if g.mixed_block else 0
        for sfb in range(first_sfb, 13):
            base = si[sfb]
            w = sw[sfb]
            for win in range(3):
                a = base + win * w
                e = 0.25 * (gain - 8.0 * g.subblock_gain[win]) - mul * (
                    sfs[sfb, win])
                out[a: a + w] *= 2.0 ** e
    return out


def _reorder_short(xs, g: _Granule, h: FrameHeader):
    if not (g.window_switching and g.block_type == 2):
        return xs
    band = _TAB["bandinfo"][h.band_index]
    si, sw = band["shortIdx"], band["shortDiff"]
    out = xs.copy()
    first_sfb = 3 if g.mixed_block else 0
    for sfb in range(first_sfb, 13):
        base, w = si[sfb], sw[sfb]
        if w == 0:
            continue
        blockv = xs[base: base + 3 * w].reshape(3, w)
        out[base: base + 3 * w] = blockv.T.reshape(-1)
    return out


_INT_RATIO = np.tan(np.arange(7) * np.pi / 12.0)


def _stereo(xl, xr, gr_l, gr_r, h: FrameHeader, sf_r_long, sf_r_short,
            int_scale):
    ms = h.mode == 1 and (h.mode_ext & 2)
    intensity = h.mode == 1 and (h.mode_ext & 1)
    s = np.sqrt(0.5)

    def ms_band(a, b):
        l_new = (xl[a:b] + xr[a:b]) * s
        r_new = (xl[a:b] - xr[a:b]) * s
        xl[a:b], xr[a:b] = l_new, r_new

    if not intensity:
        if ms:
            ms_band(0, 576)
        return xl, xr
    # The intensity region starts at the first SCALEFACTOR BAND at or
    # above the right channel's Huffman-data end (detected on the
    # ORIGINAL right spectrum, before any MS mix) — a band straddling
    # the boundary keeps its real right-channel data (MS/LR).
    nz = np.nonzero(xr)[0]
    bound = (int(nz[-1]) + 1) if len(nz) else 0
    band = _TAB["bandinfo"][h.band_index]
    short_block = gr_r.window_switching and gr_r.block_type == 2
    if not short_block:
        li = band["longIdx"]
        start_sfb = 22
        for sfb in range(22):
            if li[sfb] >= bound:
                start_sfb = sfb
                break
        if ms:
            ms_band(0, li[min(start_sfb, 22)])
        for sfb in range(start_sfb, 22):
            a, b = li[sfb], li[sfb + 1]
            is_pos = int(sf_r_long[sfb]) if sf_r_long is not None else 7
            if not _apply_intensity(xl, xr, a, b, is_pos, h, int_scale) \
                    and ms:
                # Illegal is_pos turns intensity OFF for the band; in
                # MS+intensity frames the band decodes as MS instead.
                ms_band(a, b)
    else:
        si, sw = band["shortIdx"], band["shortDiff"]
        for sfb in range(13):
            w = sw[sfb]
            for win in range(3):
                a = si[sfb] + win * w
                in_zero = a >= bound
                is_pos = (int(sf_r_short[sfb, win])
                          if sf_r_short is not None else 7)
                if in_zero and _apply_intensity(xl, xr, a, a + w, is_pos,
                                                h, int_scale):
                    continue
                if ms:
                    ms_band(a, a + w)
    return xl, xr


def _apply_intensity(xl, xr, a, b, is_pos, h: FrameHeader, int_scale):
    """Apply intensity positioning to one band; False = the is_pos is
    the 'intensity off' marker and the band falls back to MS/LR."""
    if h.lsf:
        if is_pos == 0:
            return False
        k = 2.0 ** (-(int_scale + 1) * ((is_pos + 1) // 2) * 0.5)
        if is_pos & 1:
            xr[a:b] = xl[a:b] * k
        else:
            xr[a:b] = xl[a:b]
            xl[a:b] = xl[a:b] * k
        return True
    if is_pos >= 7:
        return False
    ratio = _INT_RATIO[is_pos]
    l = xl[a:b].copy()  # a view would alias the write below into xr's
    xl[a:b] = l * (ratio / (1.0 + ratio))
    xr[a:b] = l * (1.0 / (1.0 + ratio))
    return True


def _antialias(xs, g: _Granule):
    if g.window_switching and g.block_type == 2 and not g.mixed_block:
        return xs
    n_sb = 2 if (g.window_switching and g.block_type == 2) else 32
    for sb in range(1, n_sb):
        base = 18 * sb
        for i in range(8):
            lo = xs[base - 1 - i]
            hi = xs[base + i]
            xs[base - 1 - i] = lo * _CS[i] - hi * _CA[i]
            xs[base + i] = hi * _CS[i] + lo * _CA[i]
    return xs


# --------------------------------------------------------------------------
# Hybrid filterbank: IMDCT + overlap, then the polyphase synthesis bank
# --------------------------------------------------------------------------

def _mdct_windows():
    n = np.arange(36)
    w0 = np.sin(np.pi / 36.0 * (n + 0.5))
    w1 = w0.copy()
    w1[18:24] = 1.0
    w1[24:30] = np.sin(np.pi / 12.0 * (np.arange(6) + 0.5 + 6))
    w1[30:] = 0.0
    w3 = w0.copy()
    w3[:6] = 0.0
    w3[6:12] = np.sin(np.pi / 12.0 * (np.arange(6) + 0.5))
    w3[12:18] = 1.0
    ws = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))
    return {0: w0, 1: w1, 3: w3, 2: ws}


_WINDOWS = _mdct_windows()
_IMDCT36 = np.cos(np.pi / 72.0
                  * np.outer(2 * np.arange(36) + 19, 2 * np.arange(18) + 1))
_IMDCT12 = np.cos(np.pi / 24.0
                  * np.outer(2 * np.arange(12) + 7, 2 * np.arange(6) + 1))
_SYNTH_N = np.cos(np.pi / 64.0
                  * np.outer(16 + np.arange(64), 2 * np.arange(32) + 1))


def _build_synth_window() -> np.ndarray:
    """ISO D window from the half-window integer table: mirrored about the
    center with the sign alternating every 64 taps (the structure the
    extraction tool validates against the spec's printed table head)."""
    iw = np.asarray(_TAB["intwinbase"], np.float64)
    d = np.zeros(512)
    for i in range(512):
        k = i if i <= 256 else 512 - i
        sign = -1.0 if (i >> 6) & 1 else 1.0
        d[i] = sign * iw[k] / 65536.0
    return d


_SYNTH_D = _build_synth_window()


def _imdct_granule(xs, g: _Granule, overlap):
    """18 time samples per subband + carry the 18-sample overlap."""
    spec = xs.reshape(32, 18)
    out = np.zeros((32, 18))
    short_block = g.window_switching and g.block_type == 2
    for sb in range(32):
        use_short = short_block and (not g.mixed_block or sb >= 2)
        if use_short:
            raw = np.zeros(36)
            sub = spec[sb].reshape(6, 3)      # interleaved windows
            for w in range(3):
                xw = _IMDCT12 @ sub[:, w]
                raw[6 + 6 * w: 18 + 6 * w] += xw * _WINDOWS[2]
        else:
            bt = g.block_type if g.window_switching else 0
            if short_block and g.mixed_block and sb < 2:
                bt = 0
            raw = (_IMDCT36 @ spec[sb]) * _WINDOWS[bt]
        out[sb] = raw[:18] + overlap[sb]
        overlap[sb] = raw[18:]
    # frequency inversion: odd subbands flip odd time samples
    out[1::2, 1::2] *= -1.0
    return out


class _Synth:
    def __init__(self):
        self.v = np.zeros(1024)

    def run(self, sub: np.ndarray) -> np.ndarray:
        """``sub``: (18, 32) subband samples -> (18*32,) PCM floats."""
        out = np.empty((sub.shape[0], 32))
        v = self.v
        for t in range(sub.shape[0]):
            v = np.roll(v, 64)
            v[:64] = _SYNTH_N @ sub[t]
            u = np.empty(512)
            for i in range(8):
                u[64 * i: 64 * i + 32] = v[128 * i: 128 * i + 32]
                u[64 * i + 32: 64 * i + 64] = v[128 * i + 96: 128 * i + 128]
            w = u * _SYNTH_D
            out[t] = w.reshape(16, 32).sum(axis=0)
        self.v = v
        return out.reshape(-1)


# --------------------------------------------------------------------------
# Top-level stream decode
# --------------------------------------------------------------------------

def _skip_id3(data: bytes) -> int:
    if data[:3] == b"ID3" and len(data) >= 10:
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        return 10 + size
    return 0


def decode_mp3(data: bytes):
    """Decode an MP3 byte stream.

    Returns ``(pcm, sample_rate)`` — pcm float32 of shape (samples,
    channels) in [-1, 1].  Raises ValueError when no Layer III frame is
    found.
    """
    i = _skip_id3(data)
    reservoir = b""
    synths = None
    overlaps = None
    chunks = []
    sample_rate = None
    channels = None
    prev_long = [None, None]
    while i + 4 <= len(data):
        h = parse_frame_header(data, i)
        if h is None:
            i += 1
            continue
        frame = data[i: i + h.frame_bytes]
        if len(frame) < h.frame_bytes:
            break
        i += h.frame_bytes
        if sample_rate is None:
            sample_rate, channels = h.samplerate, h.channels
            synths = [_Synth() for _ in range(channels)]
            overlaps = [np.zeros((32, 18)) for _ in range(channels)]
        elif h.samplerate != sample_rate or h.channels != channels:
            break  # mid-stream format change: stop at the consistent prefix
        side_start = 4 + (2 if h.crc else 0)
        side_len = (9 if h.channels == 1 else 17) if h.lsf else \
                   (17 if h.channels == 1 else 32)
        br = _Bits(frame[side_start: side_start + side_len])
        main_data_begin, scfsi, granules = _read_side_info(br, h)
        main = frame[side_start + side_len:]
        if main_data_begin > len(reservoir):
            reservoir = reservoir + main   # can't locate start yet
            chunks.append(np.zeros((576 * len(granules), h.channels),
                                   np.float64))
            continue
        start_bit = (len(reservoir) - main_data_begin) * 8
        reservoir = reservoir + main
        mbr = _Bits(reservoir, start_bit)
        frame_out = []
        for gi, chs in enumerate(granules):
            xr = []
            sf_r_long = sf_r_short = None
            int_scale = 0
            for ci, g in enumerate(chs):
                limit = mbr.pos + g.part2_3_length
                if h.lsf:
                    intensity_ch = (ci == 1 and h.mode == 1
                                    and (h.mode_ext & 1))
                    longf, shortf, preflag, iscale = _read_scalefacs_lsf(
                        mbr, g, h, intensity_ch)
                    if ci == 1:
                        int_scale = iscale
                else:
                    longf, shortf = _read_scalefacs_mpeg1(
                        mbr, g, scfsi[ci] if gi else [0] * 4,
                        prev_long[ci] if gi else None)
                    preflag = g.preflag
                    if longf is not None:
                        prev_long[ci] = longf
                xs = _decode_spectrum(mbr, g, h, limit)
                xs = _requantize(xs, g, h, longf, shortf, preflag)
                xs = _reorder_short(xs, g, h)
                if ci == 1:
                    sf_r_long, sf_r_short = longf, shortf
                xr.append(xs)
            if h.channels == 2:
                xr[0], xr[1] = _stereo(xr[0], xr[1], chs[0], chs[1], h,
                                       sf_r_long, sf_r_short, int_scale)
            pcm_ch = []
            for ci in range(h.channels):
                xs = _antialias(xr[ci], chs[ci])
                sub = _imdct_granule(xs, chs[ci], overlaps[ci])
                pcm_ch.append(synths[ci].run(sub.T))
            frame_out.append(np.stack(pcm_ch, axis=1))
        chunks.append(np.concatenate(frame_out, axis=0))
        if len(reservoir) > 2048:
            trim = len(reservoir) - 1024
            reservoir = reservoir[trim:]
    if sample_rate is None:
        raise ValueError("NotImplemented: no MPEG Layer III frame found")
    pcm = (np.concatenate(chunks, axis=0) if chunks
           else np.zeros((0, channels)))
    return np.clip(pcm, -1.0, 1.0).astype(np.float32), sample_rate
