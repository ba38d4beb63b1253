"""SWF sound: wire tags, PCM codecs, and the event/stream model.

The reference renderer has no audio path; real movies do, so the
framework carries the full subsystem (framework extension; SWF spec
v19 'Sounds'):

- DefineSound (tag 14) — an event-sound character; StartSound (tag 15)
  triggers it on a timeline frame with SOUNDINFO (loops, in/out
  points, stop flag).
- SoundStreamHead/Head2 (tags 18/45) + SoundStreamBlock (tag 19) —
  the streaming track, one block per timeline frame.
- Codecs: format 0/3 (uncompressed, 16-bit LE or 8-bit unsigned) are
  decoded exactly; format 1 (SWF ADPCM, 2..5-bit codes) has a full
  decoder and a 4-bit encoder twin; format 2 (MP3) decodes through
  ``models.mp3``; Nellymoser bytes are carried (parse/emit round-trip)
  but not decoded — ``decode_sound`` raises the same NotImplemented
  error shape the bitmap service uses for foreign media types.

PCM is float32 in [-1, 1], shaped (samples, channels).
``runtime.audio`` mixes the timeline; ``utils.wav`` writes the result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FORMAT_UNCOMPRESSED = 0      # platform-endian in the spec; we read LE
FORMAT_ADPCM = 1
FORMAT_MP3 = 2
FORMAT_UNCOMPRESSED_LE = 3
FORMAT_NELLYMOSER = 6

RATES = (5512, 11025, 22050, 44100)

# IMA step table (88 entries, SWF spec ADPCM section).
_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428,
    4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086,
    29794, 32767], np.int32)

_INDEX_TABLES = {
    2: (-1, 2),
    3: (-1, -1, 2, 4),
    4: (-1, -1, -1, -1, 2, 4, 6, 8),
    5: (-1, -1, -1, -1, -1, -1, -1, -1, 1, 2, 4, 6, 8, 10, 13, 16),
}


@dataclasses.dataclass
class Sound:
    """DefineSound: an event-sound character."""

    id: int
    format: int
    rate: int                  # one of RATES
    bits: int                  # 8 or 16 (sample size on the wire)
    channels: int              # 1 or 2
    sample_count: int
    data: bytes


@dataclasses.dataclass(frozen=True)
class SoundInfo:
    """StartSound SOUNDINFO: playback modifiers."""

    stop: bool = False
    no_multiple: bool = False
    in_point: Optional[int] = None     # samples
    out_point: Optional[int] = None    # samples
    loops: int = 1


@dataclasses.dataclass
class SoundStream:
    """SoundStreamHead(2) + its per-frame SoundStreamBlock payloads."""

    format: int
    rate: int
    bits: int
    channels: int
    samples_per_frame: int
    blocks: dict = dataclasses.field(default_factory=dict)  # frame -> bytes


# ---------------------------------------------------------------------------
# PCM codecs
# ---------------------------------------------------------------------------


def _pcm_from_int16(i16: np.ndarray, channels: int) -> np.ndarray:
    out = i16.astype(np.float32) / 32768.0
    return out.reshape(-1, channels)


def decode_uncompressed(data: bytes, bits: int,
                        channels: int) -> np.ndarray:
    """Format 0/3: 16-bit signed LE or 8-bit UNSIGNED samples,
    channel-interleaved."""
    if bits == 16:
        i16 = np.frombuffer(data[:len(data) & ~1], "<i2")
        return _pcm_from_int16(i16, channels)
    u8 = np.frombuffer(data, np.uint8).astype(np.int32)
    return _pcm_from_int16(((u8 - 128) << 8).astype(np.int16), channels)


def encode_uncompressed(pcm: np.ndarray, bits: int = 16) -> bytes:
    pcm = np.asarray(pcm, np.float32)
    i16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")
    if bits == 16:
        return i16.reshape(-1).tobytes()
    return ((i16.reshape(-1).astype(np.int32) >> 8) + 128).astype(
        np.uint8).tobytes()


class _BitReader:
    """MSB-first bit reader (the SWF ADPCM stream is bit-packed like
    the rest of the format's UB fields)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # in bits

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def remaining(self) -> int:
        return len(self.data) * 8 - self.pos


class _BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def bytes(self) -> bytes:
        while len(self.bits) % 8:
            self.bits.append(0)
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def decode_adpcm(data: bytes, channels: int) -> np.ndarray:
    """SWF ADPCM SoundData -> (samples, channels) f32.

    Layout: UB[2] code size (bits-2); then 4096-samples-per-channel
    blocks, each opening with UB[16] initial sample + UB[6] index per
    channel, followed by channel-interleaved codes."""
    r = _BitReader(data)
    nbits = r.read(2) + 2
    table = _INDEX_TABLES[nbits]
    out = []
    while r.remaining() >= channels * 22:
        samples = []
        indices = []
        for _ in range(channels):
            s = r.read(16)
            samples.append(s - 65536 if s & 0x8000 else s)
            indices.append(min(88, r.read(6)))
        block = [[s] for s in samples]
        n = 1
        while n < 4096 and r.remaining() >= nbits * channels:
            for ch in range(channels):
                code = r.read(nbits)
                step = int(_STEPS[indices[ch]])
                sign = code >> (nbits - 1)
                mag = code & ((1 << (nbits - 1)) - 1)
                delta = step >> (nbits - 1)
                for i in range(nbits - 1):
                    if (mag >> (nbits - 2 - i)) & 1:
                        delta += step >> (i + 1)
                s = samples[ch] + (-delta if sign else delta)
                s = max(-32768, min(32767, s))
                samples[ch] = s
                block[ch].append(s)
                idx = indices[ch] + table[mag]
                indices[ch] = max(0, min(88, idx))
            n += 1
        frames = np.stack([np.array(b, np.int32) for b in block], axis=1)
        out.append(frames)
    if not out:
        return np.zeros((0, channels), np.float32)
    return np.concatenate(out, axis=0).astype(np.float32) / 32768.0


def encode_adpcm(pcm: np.ndarray) -> bytes:
    """f32 PCM -> SWF ADPCM SoundData (4-bit codes, the decode twin).

    Lossy by design; ``decode_adpcm(encode_adpcm(x))`` tracks x within
    the quantizer's error envelope (tests pin the RMS)."""
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    i16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(
        np.int32)
    channels = i16.shape[1]
    nbits = 4
    table = _INDEX_TABLES[nbits]
    w = _BitWriter()
    w.write(nbits - 2, 2)
    for start in range(0, len(i16), 4096):
        block = i16[start:start + 4096]
        samples = [int(block[0, ch]) for ch in range(channels)]
        indices = [0] * channels
        for ch in range(channels):
            w.write(samples[ch] & 0xFFFF, 16)
            w.write(indices[ch], 6)
        for n in range(1, len(block)):
            for ch in range(channels):
                target = int(block[n, ch])
                step = int(_STEPS[indices[ch]])
                diff = target - samples[ch]
                sign = 1 if diff < 0 else 0
                mag_target = -diff if sign else diff
                # Greedy magnitude fit: bit i contributes step >> (i+1),
                # baseline step >> (nbits-1).
                mag = 0
                acc = step >> (nbits - 1)
                for i in range(nbits - 1):
                    contrib = step >> (i + 1)
                    if acc + contrib <= mag_target:
                        acc += contrib
                        mag |= 1 << (nbits - 2 - i)
                code = (sign << (nbits - 1)) | mag
                w.write(code, nbits)
                s = samples[ch] + (-acc if sign else acc)
                samples[ch] = max(-32768, min(32767, s))
                indices[ch] = max(0, min(88, indices[ch] + table[mag]))
    return w.bytes()


def _linear_resample(pcm: np.ndarray, src: int, dst: int) -> np.ndarray:
    if src == dst or pcm.shape[0] == 0:
        return pcm
    n_out = int(round(pcm.shape[0] * dst / src))
    t_out = np.arange(n_out) * (src / dst)
    t_in = np.arange(pcm.shape[0])
    return np.stack([np.interp(t_out, t_in, pcm[:, c])
                     for c in range(pcm.shape[1])], axis=1).astype(
        np.float32)


def decode_sound(format: int, data: bytes, bits: int, channels: int,
                 sample_count: Optional[int] = None,
                 declared_rate: Optional[int] = None) -> np.ndarray:
    """Decode one sound payload to (samples, channels) f32.

    ``sample_count`` trims the result (DefineSound declares it; ADPCM
    byte-alignment padding otherwise decodes as spurious trailing
    samples — one per block tail, enough to drift a stream mix).

    ``declared_rate``: the SWF tag's rate enum value.  MP3 frames carry
    their OWN sample rate (the MPEG enum covers rates the SWF field
    cannot express — 8/12/16/24/32/48 kHz; the player derives timing
    from the frames), so when the true rate differs the PCM is
    resampled to the declared rate, keeping downstream scheduling —
    which uses the tag's rate — pitch-correct."""
    if format in (FORMAT_UNCOMPRESSED, FORMAT_UNCOMPRESSED_LE):
        pcm = decode_uncompressed(data, bits, channels)
    elif format == FORMAT_ADPCM:
        pcm = decode_adpcm(data, channels)
    elif format == FORMAT_MP3:
        # MP3SOUNDDATA (SWF spec): s16 LE SeekSamples, then MPEG frames.
        # SeekSamples skips encoder-delay samples from the decode head.
        from .mp3 import decode_mp3

        seek = int.from_bytes(data[:2], "little", signed=True)
        pcm, mp3_rate = decode_mp3(data[2:])
        if seek > 0:
            pcm = pcm[seek:]
        if declared_rate and mp3_rate != declared_rate:
            pcm = _linear_resample(pcm, mp3_rate, declared_rate)
    else:
        raise NotImplementedError(
            f"NotImplemented: Support for sound format {format}")
    if sample_count is not None:
        pcm = pcm[:sample_count]
    return pcm
