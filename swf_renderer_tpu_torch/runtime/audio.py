"""Timeline audio: mix a movie's event sounds + stream into one PCM track.

Port of ``swf_renderer_tpu/runtime/audio.py``: the same arithmetic in
the same order, so the mixed track is byte-equal to the reference's,
and the reference's defects kept (an MP3 event sound is resampled
twice: to its DefineSound rate in ``decode_sound``, then to the mix
rate; ``button_transition_pcm`` decodes anew on every call; SOUNDINFO
envelopes are dropped by the loader).  The audio twin of
``runtime.movie``'s visual loaders; host code.  StartSound events trigger
DefineSound characters at their frame's time (with SOUNDINFO in/out
points, loop counts, and the stop/no-multiple flags); SoundStreamBlock
payloads play back-to-back from the first block's frame.  Everything
is mixed offline at ``rate`` into float32 (samples, 2), clipped to
[-1, 1] — ``utils.wav.write_wav`` serializes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.sound import FORMAT_MP3, decode_sound
from ..models.swf_binary import Movie


def _resample(pcm: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate or pcm.shape[0] == 0:
        return pcm
    n_out = int(round(pcm.shape[0] * dst_rate / src_rate))
    t_out = np.arange(n_out) * (src_rate / dst_rate)
    t_in = np.arange(pcm.shape[0])
    return np.stack([np.interp(t_out, t_in, pcm[:, c])
                     for c in range(pcm.shape[1])], axis=1).astype(
        np.float32)


def _to_stereo(pcm: np.ndarray) -> np.ndarray:
    if pcm.shape[1] == 2:
        return pcm
    return np.repeat(pcm, 2, axis=1)


def _event_pcm(snd, info, rate: int, cache: dict) -> np.ndarray:
    """One StartSound instance's samples: decode (once per sound id —
    retriggered ADPCM clicks shouldn't re-run the bit reader), apply
    in/out points (sample indices at the SOUND's rate, player
    semantics), loop, resample to the mix rate."""
    pcm = cache.get(snd.id)
    if pcm is None:
        pcm = decode_sound(snd.format, snd.data, snd.bits, snd.channels,
                           snd.sample_count, declared_rate=snd.rate)
        cache[snd.id] = pcm
    lo = min(info.in_point or 0, pcm.shape[0])
    hi = (min(info.out_point, pcm.shape[0])
          if info.out_point is not None else pcm.shape[0])
    pcm = pcm[lo:hi]
    if info.loops > 1:
        pcm = np.tile(pcm, (info.loops, 1))
    return _to_stereo(_resample(pcm, snd.rate, rate))


def button_transition_pcm(movie: Movie, button_id: int, transition: str,
                          rate: int = 44100) -> Optional[np.ndarray]:
    """The PCM a button plays on one state transition, or None.

    ``transition``: one of swf_binary.BUTTON_SOUND_TRANSITIONS
    (DefineButtonSound wire order).  Interaction timing is the
    embedder's job (the frame server's button_state switches select
    what to DRAW); this resolves what to PLAY — decoded, SOUNDINFO
    (in/out points, loops) applied, float32 (samples, 2) at ``rate``.
    A stop-flagged slot returns an empty track (the player cuts the
    sound)."""
    from ..models.swf_binary import BUTTON_SOUND_TRANSITIONS

    slots = movie.button_sounds.get(button_id)
    if slots is None:
        return None
    try:
        idx = BUTTON_SOUND_TRANSITIONS.index(transition)
    except ValueError:
        raise ValueError(
            f"unknown button transition {transition!r}; expected one "
            f"of {BUTTON_SOUND_TRANSITIONS}") from None
    entry = slots[idx]
    if entry is None:
        return None
    sid, info = entry
    snd = movie.sounds.get(sid)
    if snd is None:
        return None
    if info.stop:
        return np.zeros((0, 2), np.float32)
    return _event_pcm(snd, info, rate, {})


def _stream_pcm(stream):
    """Decode a SoundStreamHead's blocks -> (pcm, source_rate,
    first_block_frame).  MP3 blocks decode as ONE stream (the Layer III
    bit reservoir crosses block boundaries) at the MPEG frames' own
    rate; other codecs decode per block at the head's declared rate."""
    first = min(stream.blocks)
    if stream.format == FORMAT_MP3:
        # MP3STREAMSOUNDDATA: u16 SampleCount + s16 SeekSamples per
        # block, then raw MPEG frames.
        from ..models.mp3 import decode_mp3

        total_samples = 0
        seek = 0
        parts = []
        for bi, f in enumerate(sorted(stream.blocks)):
            blk = stream.blocks[f]
            total_samples += int.from_bytes(blk[:2], "little")
            if bi == 0:
                seek = int.from_bytes(blk[2:4], "little", signed=True)
            parts.append(blk[4:])
        pcm, mp3_rate = decode_mp3(b"".join(parts))
        if seek > 0:
            pcm = pcm[seek:]
        if total_samples:
            pcm = pcm[:total_samples]
        # The MPEG frames carry the TRUE rate (the SWF enum cannot
        # express 8/12/16/24/32/48 kHz); resample from that, not the
        # head's declared enum value.
        return pcm, mp3_rate, first
    pcm_blocks = [
        decode_sound(stream.format, stream.blocks[f], stream.bits,
                     stream.channels, stream.samples_per_frame)
        for f in sorted(stream.blocks)]
    return np.concatenate(pcm_blocks, axis=0), stream.rate, first


def mix_movie_audio(movie: Movie, n_frames: Optional[int] = None,
                    rate: int = 44100) -> np.ndarray:
    """The movie's mixed audio track as float32 (samples, 2).

    ``n_frames`` bounds the timeline length (default: every ShowFrame;
    sounds ring past the last frame rather than truncating, like the
    player letting an event sound finish)."""
    frames = n_frames if n_frames is not None else max(
        len(movie.frames), 1)
    spf = rate / max(movie.frame_rate, 1e-6)
    chunks = []  # (start_sample, pcm, sound_id or None)

    decoded: dict = {}
    active_by_id: dict = {}
    for f in sorted(movie.sound_events):
        if f >= frames:
            continue
        start = int(round(f * spf))
        for sid, info in movie.sound_events[f]:
            snd = movie.sounds.get(sid)
            if snd is None:
                continue
            if info.stop:
                # syncStop: every playing instance of this sound is cut
                # at this frame.
                for entry in active_by_id.get(sid, ()):
                    s0, pcm = entry
                    entry[1] = pcm[:max(0, start - s0)]
                active_by_id[sid] = []
                continue
            if info.no_multiple and any(
                    s0 + len(pcm) > start
                    for s0, pcm in active_by_id.get(sid, ())):
                continue
            pcm = _event_pcm(snd, info, rate, decoded)
            entry = [start, pcm]
            active_by_id.setdefault(sid, []).append(entry)
            chunks.append(entry)

    stream = movie.sound_stream
    if stream is not None and stream.blocks:
        pcm, src_rate, first = _stream_pcm(stream)
        chunks.append([int(round(first * spf)),
                       _to_stereo(_resample(pcm, src_rate, rate))])

    # Sprite-local sound streams (round 5): a sprite instance's stream
    # plays from the frame the instance is PLACED (its timeline clock);
    # one pass per placement, not per loop (documented approximation —
    # the player restarts a looping sprite's stream each loop).
    scheduled = set()
    for fi, placements in enumerate(movie.frames):
        if fi >= frames:
            break
        for p in placements:
            cid = getattr(p, "character_id", None)
            sprite = movie.sprites.get(cid) if cid is not None else None
            if (sprite is None or sprite.sound_stream is None
                    or not sprite.sound_stream.blocks):
                continue
            placed = getattr(p, "placed_frame", fi)
            key = (cid, p.depth, placed)
            if placed != fi or key in scheduled:
                continue
            scheduled.add(key)
            pcm, src_rate, s_first = _stream_pcm(sprite.sound_stream)
            chunks.append([int(round((fi + s_first) * spf)),
                           _to_stereo(_resample(pcm, src_rate, rate))])

    total = int(np.ceil(frames * spf))
    for s0, pcm in chunks:
        total = max(total, s0 + pcm.shape[0])
    out = np.zeros((total, 2), np.float32)
    for s0, pcm in chunks:
        out[s0:s0 + pcm.shape[0]] += pcm
    return np.clip(out, -1.0, 1.0)
