"""Minimal RIFF/WAVE writer + reader (16-bit PCM) for the audio track.

Port of ``swf_renderer_tpu/utils/wav.py`` (byte-equal output).  The
audio analog of ``utils.pam`` — a dependency-free serialization of
``runtime.audio.mix_movie_audio``'s float32 output.
"""

from __future__ import annotations

import struct

import numpy as np


def wav_bytes(pcm: np.ndarray, rate: int = 44100) -> bytes:
    """float32 (N, C) in [-1, 1] -> 16-bit PCM WAVE bytes."""
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    i16 = np.clip(np.round(pcm * 32767.0), -32768, 32767).astype("<i2")
    data = i16.reshape(-1).tobytes()
    channels = pcm.shape[1]
    block = channels * 2
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * block,
                      block, 16)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
            + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def write_wav(path, pcm: np.ndarray, rate: int = 44100) -> None:
    with open(path, "wb") as f:
        f.write(wav_bytes(pcm, rate))


def read_wav(data: bytes):
    """WAVE bytes -> (float32 (N, C), rate).  16-bit PCM only."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAVE file")
    pos = 12
    fmt = None
    pcm = None
    rate = None
    channels = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            tag, channels, rate, _br, _ba, bits = struct.unpack_from(
                "<HHIIHH", body, 0)
            if tag != 1 or bits != 16:
                raise ValueError("only 16-bit PCM WAVE is supported")
            fmt = True
        elif cid == b"data":
            pcm = np.frombuffer(body[:len(body) & ~1], "<i2")
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    return (pcm.astype(np.float32) / 32767.0).reshape(-1, channels), rate
