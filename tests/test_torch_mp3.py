"""The port's MP3 decoder (``swf_renderer_tpu_torch/models/mp3.py``)
against the JAX package's on the CPU.

Both are host numpy with the same arithmetic in the same order, so every
comparison is exact: equal arrays (dtype and shape too), equal rates,
equal frame headers, or the same exception type and message.  The
streams are made in code (``utils/movie_scenes.py`` ``mp3_stream``: valid
Layer III headers, side information drawn field by field, seeded main
data), over MPEG-1 / 2 / 2.5, the four channel modes, with and without
the CRC word, some behind an ID3v2 tag; the reference's own fixtures
(pygame's ``house_lo.mp3``, gsutil's ``test.mp3``) are decoded too where
they are installed.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from swf_renderer_tpu.models import mp3 as jmp3
from swf_renderer_tpu_torch.models import mp3 as tmp3
from swf_renderer_tpu_torch.utils.movie_scenes import mp3_stream
from tests import test_mp3 as ref_mp3_tests

# The reference's fixtures, where its tests find them (pygame's example
# data, gsutil's test data); the cases that read them skip when absent.
HOUSE_LO = ref_mp3_tests.FIXTURE
GSUTIL_MP3 = ref_mp3_tests.MPEG2_FIXTURE


def _grab(fn):
    """fn()'s result, or the exception's (type name, message)."""
    try:
        return fn()
    except Exception as exc:  # the types are compared
        return type(exc).__name__, str(exc)


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def decode_both(data):
    """(port, reference) results of ``decode_mp3``: (pcm, rate) or the
    exception's (type name, message)."""
    return [_grab(lambda: mod.decode_mp3(data)) for mod in (tmp3, jmp3)]


def assert_decodes_equal(data):
    got, want = decode_both(data)
    if isinstance(want[0], str):
        assert got == want
        return None
    assert_same(got[0], want[0])
    assert got[1] == want[1]
    return got


def test_tables_are_the_references():
    """The port's table file is a byte copy; the LUTs built from it are
    equal, and structurally valid (the reference's invariants)."""
    here = pathlib.Path(tmp3.__file__).with_name("_mp3_tables.json")
    there = pathlib.Path(jmp3.__file__).with_name("_mp3_tables.json")
    assert here.read_bytes() == there.read_bytes()
    assert tmp3._TAB == jmp3._TAB
    assert tmp3._HUFF.keys() == jmp3._HUFF.keys()
    for t, lut in tmp3._HUFF.items():
        ref = jmp3._HUFF[t]
        if lut is None:
            assert ref is None
            continue
        assert (lut.maxlen, lut.linbits) == (ref.maxlen, ref.linbits)
        assert_same(lut.sym, ref.sym)
        assert_same(lut.ln, ref.ln)
        assert (lut.ln > 0).all(), f"table {t} has holes"
    assert_same(tmp3._QUAD_A.sym, jmp3._QUAD_A.sym)
    assert_same(tmp3._QUAD_A.ln, jmp3._QUAD_A.ln)
    for row in tmp3._TAB["bandinfo"]:
        assert row["longIdx"][0] == 0 and row["longIdx"][-1] == 576
        assert sum(row["longDiff"]) == 576
        assert 3 * sum(row["shortDiff"]) == 576
    assert_same(tmp3._SYNTH_D, jmp3._SYNTH_D)


def test_every_header_parses_as_the_references():
    """Every version, bitrate index, sample-rate index, mode and CRC flag
    (and padding, layer and mode extension on the way)."""
    seen = 0
    for version in range(4):
        for layer in range(4):
            for crc in (0, 1):
                b1 = 0xE0 | version << 3 | layer << 1 | crc
                for br in range(16):
                    for sr in range(4):
                        for pad in (0, 1):
                            b2 = br << 4 | sr << 2 | pad << 1
                            for mode in range(4):
                                b3 = mode << 6 | (br % 4) << 4
                                data = bytes((0xFF, b1, b2, b3)) + bytes(8)
                                got = tmp3.parse_frame_header(data, 0)
                                want = jmp3.parse_frame_header(data, 0)
                                if want is None:
                                    assert got is None
                                    continue
                                seen += 1
                                assert (dataclasses.astuple(got)
                                        == dataclasses.astuple(want))
    assert seen == 3 * 14 * 3 * 2 * 2 * 4   # Layer III, no free format
    for data, i, parses in ((b"\x00\x00\x00\x00", 0, False),
                            (b"\xff\xfb\x90", 0, False),
                            (b"\x00\xff\xfb\x90\x64", 1, True)):
        got = tmp3.parse_frame_header(data, i)
        want = jmp3.parse_frame_header(data, i)
        assert (got is None) == (want is None) == (not parses)
        if parses:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


STREAMS = [(version, mode, crc) for version in (3, 2, 0)
           for mode in range(4) for crc in (False, True)]


@pytest.mark.parametrize("version,mode,crc", STREAMS)
def test_synthetic_streams_decode_equal(version, mode, crc):
    """12 frames each; the bitrate and sample-rate indices move with the
    case, every third stream starts with an ID3v2 tag."""
    seed = STREAMS.index((version, mode, crc))
    data = mp3_stream(12, version=version, mode=mode, crc=crc, seed=seed,
                      bitrate_index=1 + (5 * seed) % 14,
                      rate_index=seed % 3, id3=seed % 3 == 0)
    pcm, rate = assert_decodes_equal(data)
    assert pcm.shape == (12 * (1152 if version == 3 else 576),
                         1 if mode == 3 else 2)
    assert rate == jmp3._SR_BASE[version][seed % 3]


GRANULES = {   # _Granule fields of each window form
    "long": {},
    "start": dict(window_switching=1, block_type=1),
    "short": dict(window_switching=1, block_type=2),
    "mixed": dict(window_switching=1, block_type=2, mixed_block=1),
    "stop": dict(window_switching=1, block_type=3),
    "reserved": dict(window_switching=1, block_type=0),
}


@pytest.mark.parametrize("kind", list(GRANULES))
def test_imdct_granule_equal(kind):
    """Seeded spectra through the hybrid filterbank's first half, three
    granules in a row (the overlap carries); no clip applies here."""
    fields = GRANULES[kind]
    rng = np.random.default_rng(len(kind))
    ovl_t, ovl_j = np.zeros((32, 18)), np.zeros((32, 18))
    for _ in range(3):
        xs = rng.standard_normal(576) * 0.3
        got = tmp3._imdct_granule(xs.copy(), tmp3._Granule(**fields), ovl_t)
        want = jmp3._imdct_granule(xs.copy(), jmp3._Granule(**fields), ovl_j)
        assert_same(got, want)
        assert_same(ovl_t, ovl_j)


def test_synthesis_filterbank_equal():
    """``_Synth.run`` on seeded subband samples, four granules through
    one filterbank (its 1024-sample state carries), before any clip."""
    rng = np.random.default_rng(5)
    st, sj = tmp3._Synth(), jmp3._Synth()
    for _ in range(4):
        sub = rng.standard_normal((18, 32)) * 0.5
        assert_same(st.run(sub), sj.run(sub))
        assert_same(st.v, sj.v)


@pytest.mark.parametrize("mod", [tmp3, jmp3], ids=["port", "jax"])
def test_stereo_ms_and_intensity_band_rules(mod):
    """The reference's band-rule case (tests/test_mp3.py), on both
    packages, and the two packages' channels equal."""
    h = mod.FrameHeader(version=3, bitrate=128, samplerate=44100, padding=0,
                        channels=2, mode=1, mode_ext=3, crc=False,
                        frame_bytes=418, band_index=0, lsf=False)
    g = mod._Granule()
    li = mod._TAB["bandinfo"][0]["longIdx"]
    bound = li[10]
    xl = np.ones(576)
    xr = np.zeros(576)
    xr[:bound] = 0.5
    sf_r = np.zeros(22, np.int32)
    sf_r[12] = 3
    sf_r[14] = 7
    l, r = mod._stereo(xl.copy(), xr.copy(), g, g, h, sf_r, None, 0)
    s = np.sqrt(0.5)
    np.testing.assert_allclose(l[:bound], (1.0 + 0.5) * s)
    np.testing.assert_allclose(r[:bound], (1.0 - 0.5) * s)
    ratio = np.tan(3 * np.pi / 12.0)
    a, b = li[12], li[13]
    np.testing.assert_allclose(l[a:b], ratio / (1 + ratio))
    np.testing.assert_allclose(r[a:b], 1.0 / (1 + ratio))
    a, b = li[14], li[15]
    np.testing.assert_allclose(l[a:b], 1.0 * s)
    np.testing.assert_allclose(r[a:b], 1.0 * s)
    sf_r2 = np.zeros(22, np.int32)
    l2, r2 = mod._stereo(xl.copy(), xr.copy(), g, g, h, sf_r2, None, 0)
    a, b = li[12], li[13]
    np.testing.assert_allclose(l2[a:b], 0.0)
    np.testing.assert_allclose(r2[a:b], 1.0)
    other = jmp3 if mod is tmp3 else tmp3
    h2 = other.FrameHeader(**dataclasses.asdict(h))
    g2 = other._Granule()
    l3, r3 = other._stereo(xl.copy(), xr.copy(), g2, g2, h2, sf_r, None, 0)
    assert_same(l, l3)
    assert_same(r, r3)


def _fuzz_buffers():
    """The reference's 24 fuzz inputs (tests/test_mp3.py), in order."""
    rng = np.random.default_rng(0)
    real = (HOUSE_LO.read_bytes() if HOUSE_LO.exists()
            else b"\xff\xe2" * 600)
    out = []
    for trial in range(24):
        kind = trial % 3
        if kind == 0:
            buf = bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
        elif kind == 1:
            buf = real[: int(rng.integers(100, len(real)))]
        else:
            b = bytearray(real[:20000])
            for _ in range(30):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            buf = bytes(b)
        out.append(buf)
    return out


@pytest.mark.parametrize("trial", range(24))
def test_fuzzed_streams_agree(trial):
    """Random, truncated and corrupted streams: equal arrays, or the same
    exception (a ValueError, as the reference's test requires)."""
    got, want = decode_both(_fuzz_buffers()[trial])
    if isinstance(want[0], str):
        assert got == want and want[0] == "ValueError"
    else:
        assert_same(got[0], want[0])
        assert got[1] == want[1] > 0 and got[0].ndim == 2


def test_non_mp3_data_raises_as_the_reference():
    for data in (b"\x00" * 1000, b"", b"ID3\x03\x00\x00\x00\x00\x00\x05xx"):
        got, want = decode_both(data)
        assert got == want and want[0] == "ValueError"


@pytest.mark.skipif(not HOUSE_LO.exists(), reason="fixture absent")
def test_house_lo_decodes_equal():
    """The reference's MPEG-2.5 oracle fixture (11025 Hz, mono)."""
    pcm, rate = assert_decodes_equal(HOUSE_LO.read_bytes())
    assert rate == 11025 and pcm.shape[1] == 1


@pytest.mark.skipif(not GSUTIL_MP3.exists(), reason="fixture absent")
def test_gsutil_mpeg2_stream_decodes_equal():
    """An ID3-prefixed MPEG-2 (22.05 kHz LSF) silent stream."""
    pcm, rate = assert_decodes_equal(GSUTIL_MP3.read_bytes())
    assert rate == 22050 and abs(pcm.shape[0] - 25920) <= 1152
    assert float(np.abs(pcm).max()) < 1e-4
